"""The port's bench (`cli bench`, feed_forward_vqgan_clip_tpu_torch/bench.py) on
the CPU, at a tiny model, against the JAX package's root `bench.py`.

Each leg runs through `bench.main([... "--device", "cpu"])` with `entry` built
at the tiny CLIP, a Mixer of dim 16 and depth 2 over 4 x 4 tokens and a tiny
VQGAN. Every JSON line it prints must carry one of the JAX bench's metric
names with exactly the keys that bench's line of that name has (read from the
text of the root `bench.py`, which is not imported: it imports JAX inside its
functions), with finite positive values. The CLI registers every subcommand and
alias of the JAX package's `cli.build_parser()`.
"""

import ast
import functools
import json
import math
from pathlib import Path

import pytest

from feed_forward_vqgan_clip_tpu import cli as jcli
from feed_forward_vqgan_clip_tpu_torch import bench, cli
from feed_forward_vqgan_clip_tpu_torch import entry as entry_module
from feed_forward_vqgan_clip_tpu_torch.infer import build_generator

REPO = Path(__file__).resolve().parents[1]
TINY_VQ = dict(n_embed=32, embed_dim=8, z_channels=8, ch=8, ch_mult=(1, 2),
               num_res_blocks=1, attn_resolutions=(4,), resolution=8)
TINY = dict(clip_model="tiny", dim=16, depth=2, vq_image_size=4)


def jax_bench_lines():
    """{metric name: the keys of its JSON line} from the root bench.py's text."""
    lines = {}
    for node in ast.walk(ast.parse((REPO / "bench.py").read_text())):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys:
                name = node.values[keys.index("metric")].value
                lines[name] = set(keys)
    return lines


@pytest.fixture
def tiny_bench(monkeypatch):
    """The bench's legs at the tiny model, with short repetitions."""
    monkeypatch.setattr(entry_module, "build_generator",
                        functools.partial(build_generator, vqgan_config=TINY_VQ, **TINY))
    monkeypatch.setattr(bench, "train_entry", functools.partial(
        entry_module.train_entry, cutn=2, mapper_config=dict(TINY, vqgan_arch=TINY_VQ)))
    monkeypatch.setattr(bench, "TIMED_SECONDS", 0.2)
    monkeypatch.setattr(bench, "LATENCY_REQUESTS", 10)
    return bench


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_jax_bench_lines_are_read():
    lines = jax_bench_lines()
    assert sorted(lines) == sorted(bench.METRICS.values())
    assert lines[bench.METRICS["train"]] >= {"train_step_ms", "vs_baseline_util20"}


@pytest.mark.parametrize("mode", ["infer", "latency", "train"])
def test_bench_leg_prints_the_jax_line(tiny_bench, capsys, mode):
    tiny_bench.main(["--mode", mode, "--batch", "2", "--train-batch", "2", "--device", "cpu"])
    out, err = capsys.readouterr()
    (line,) = _json_lines(out)
    assert line["metric"] == bench.METRICS[mode]
    assert set(line) == jax_bench_lines()[line["metric"]]
    for key, value in line.items():
        if key not in ("metric", "unit") and value is not None:
            assert math.isfinite(value) and value > 0, (key, value)
    assert f"# {mode}:" in err and "cpu: host-clock times" in err


def test_bench_all_repeats_the_headline_last(tiny_bench, capsys):
    cli.main(["bench", "--batch", "2", "--train-batch", "2", "--fuse-augs",
              "--opt-dtype", "float32", "--device", "cpu"])
    out, err = capsys.readouterr()
    lines = _json_lines(out)
    assert [x["metric"] for x in lines] == [bench.METRICS[m] for m in
                                            ("infer", "train", "latency", "infer")]
    assert lines[-1] == lines[0]
    assert "fuse_geometric=True, Adam moments float32" in err


def test_bench_leg_that_raises_is_not_swallowed(tiny_bench, monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("a leg fails")

    monkeypatch.setattr(bench, "train_entry", broken)
    with pytest.raises(RuntimeError, match="a leg fails"):
        bench.main(["--batch", "2", "--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    assert [x["metric"] for x in lines] == [bench.METRICS["infer"]]  # no repeated headline


def _subcommands(parser):
    (sub,) = [a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction"]
    return set(sub.choices)


def test_cli_registers_every_jax_subcommand_and_alias():
    want = _subcommands(jcli.build_parser())
    assert "bench" in want and "train_prior" in want
    assert want <= _subcommands(cli.build_parser())


def test_cli_bench_flags_parse():
    args = cli.build_parser().parse_args(["bench", "--mode", "latency", "--batch", "64",
                                          "--train-batch", "16", "--fuse-augs",
                                          "--opt-dtype", "float32", "--device", "cpu"])
    assert (args.mode, args.batch, args.train_batch, args.fuse_augs, args.opt_dtype,
            args.device) == ("latency", 64, 16, True, "float32", "cpu")
    assert args.fn.__name__ == "_cmd_bench"
    default = cli.build_parser().parse_args(["bench"])
    assert (default.mode, default.batch, default.train_batch, default.fuse_augs,
            default.opt_dtype, default.device) == ("all", 256, 8, False, "bfloat16", "cuda")
