"""The readings the limits of `correct` are set from (not run by the benchmark's
own runs): one process runs a cell on each of several seeds with a short
window, and prints for each the program's readings and the control's, the
reference computed one precision below the configuration's in the program's
place (reference/compare.py, reference/train.py). With `--fault` a fault is
planted under the timed path instead, and the program's readings are read;
`--no-control` reads the program's alone.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]
        [--fault none|half_batch|unchanged|answer] [--no-control] [--out readings.jsonl]

Faults: `half_batch` takes the loss's mean over half of the batch's images
and leaves the rest out; `unchanged` makes Adam return the state unchanged;
`answer` alters one codebook row the search returns in each image (its first
latent's), so that any sample of images holds one.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "feed_forward_vqgan_clip_tpu_torch"


def plant(fault, patches, batch):
    """Swap the program's function for a faulty one (undone by `patches`);
    `batch`: the cell's images a step."""
    import importlib

    import torch

    if fault == "half_batch":
        loop = importlib.import_module(f"{PORT}.train.loop")
        orig = loop.spherical_dist_loss

        def half(a, b):  # rows are cutout-major: row r is image r % batch
            keep = torch.arange(a.shape[0], device=a.device) % batch < batch // 2
            return orig(a[keep], b[keep])

        patches.set(loop, "spherical_dist_loss", half)
    if fault == "unchanged":
        state = importlib.import_module(f"{PORT}.train.state")
        patches.set(state.TrainState, "apply_gradients", lambda self: self)
    if fault == "answer":
        quant = importlib.import_module(f"{PORT}.ops.quantize")
        orig_q = quant.quantize_indices

        def altered(x, codebook):
            idx = orig_q(x, codebook).clone()
            first = idx.view(idx.shape[0], -1)[:, 0]
            first.copy_((first + 1) % codebook.shape[0])
            return idx

        patches.set(quant, "quantize_indices", altered)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default="none",
                   choices=("none", "half_batch", "unchanged", "answer"))
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from perfbench.harness import cell as C
    from perfbench.harness.capture import Patches

    c = C.load_cell(args.workload)
    traffic = C.load_module(C.BENCH / "traffic" / f"{c.mix['generator']}.py")
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = C.Ctx(cell=c, seed=seed, seconds=args.seconds, trace=False,
                    device=torch.device("cuda", 0), t_start=time.perf_counter(),
                    control=args.fault == "none" and not args.no_control)
        patches = Patches()
        plant(args.fault, patches, c.mix.get("batch", 1))
        try:
            o = traffic.run(ctx)
        finally:
            patches.undo()
        rec = {"workload": c.name, "seed": seed, "fault": args.fault, "program": o.checks,
               "control": o.control, "metrics": o.metrics, "setup_s": ctx.setup_s,
               "attempted": o.attempted, "failed": o.failed, "peak": ctx.peak_bytes}
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
