"""Host ms a request in make_grid and save_image, as the Predictor calls them."""

from perfbench.harness import readers


def read(ctx, outcome):
    return readers.host_ms_per(ctx, outcome, "serve.png", "serve.request")
