"""Gradio web app over the Predictor.

Port of feed_forward_vqgan_clip_tpu/serve/app.py: text prompt, model dropdown,
prior checkbox, grid-size dropdown, seed slider -> image. gradio is optional
and not a dependency: `build_fn` is the gradio-free callback, and `build_app`
raises ImportError without gradio.
"""

from glob import glob
from typing import Optional, Sequence

from feed_forward_vqgan_clip_tpu_torch.serve.predictor import Predictor


def build_fn(model_paths: Optional[Sequence[str]] = None, out_path: str = "gradio_out.png",
             *, device="cuda"):
    """-> (fn, model names): fn(prompt, model, prior, grid_size, seed) -> PNG path,
    over a set-up Predictor of `model_paths` (default: the .th files in the
    working directory)."""
    if not model_paths:
        model_paths = sorted(glob("*.th"))
    predictor = Predictor(model_paths, device=device)
    predictor.setup()
    names = list(predictor.models)

    def fn(prompt, model, prior, grid_size, seed):
        return predictor.predict(prompt, model=model or None, prior=bool(prior),
                                 grid_size=grid_size, seed=int(seed), out_path=out_path)

    return fn, names


def build_app(model_paths: Optional[Sequence[str]] = None, *, device="cuda"):
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; `pip install gradio` to serve the web app"
        ) from e

    fn, names = build_fn(model_paths, device=device)
    return gr.Interface(
        fn=fn,
        inputs=[
            gr.Textbox(label="Prompt"),
            gr.Dropdown(names, label="Model", value=names[0] if names else None),
            gr.Checkbox(label="Use prior"),
            gr.Dropdown(["1x1", "2x2", "3x3", "4x4"], value="1x1", label="Grid"),
            gr.Slider(0, 2**31 - 1, step=1, value=0, label="Seed"),
        ],
        outputs=gr.Image(type="filepath"),
        title="feed_forward_vqgan_clip_tpu_torch",
    )


if __name__ == "__main__":
    build_app().launch()
