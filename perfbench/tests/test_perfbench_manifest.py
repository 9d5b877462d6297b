"""BENCHMARK.json against the benchmark's contract, the import check, the FLOP
counts, and a cell found by name in files a later change only adds."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench.counts import flops
from perfbench.harness import cell as C
from perfbench.harness import program
from perfbench.reference import models as R
from perfbench.reference import train as T

ROOT = C.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expansion|width")


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(names) == len(set(names))
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"] == cells
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    for cell in cells:
        c = C.load_cell(cell, MANIFEST)
        assert len(c.end_to_end) >= 2 and c.per_layer, cell
    assert {c["name"] for c in MANIFEST["configs"]} == {w["config"] for w in MANIFEST["workloads"]}


def test_every_name_has_its_files():
    for w in MANIFEST["workloads"]:
        c = C.load_cell(w["name"], MANIFEST)
        assert (C.BENCH / "traffic" / f"{c.mix['generator']}.py").exists()
        assert set(c.limits), w["name"]
    for m in MANIFEST["per_layer"]:
        assert (C.BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]


@pytest.mark.parametrize("name,forbidden", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("optax", True), ("feed_forward_vqgan_clip_tpu", True), ("feed_forward_vqgan_clip_tpu.cli", True),
    ("feed_forward_vqgan_clip_tpu_torch", False), ("feed_forward_vqgan_clip_tpu_torch.entry", False),
    ("jaxtyping", False), ("flaxen", False), ("perfbench.harness", False),
])
def test_import_check_compares_whole_top_level_names(name, forbidden):
    assert bool(program.forbidden_modules([name])) == forbidden


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                yield arg.value


def test_no_file_imports_jax_and_the_reference_imports_no_program():
    for path in C.BENCH.rglob("*.py"):
        mods = list(_imports(path))
        assert not program.forbidden_modules(mods), (path, mods)
        if "reference" in path.parts:
            assert not any(m.split(".")[0] == program.PORT for m in mods), path


def test_run_imports_no_jax():
    code = ("import sys, runpy; sys.argv=['run.py','--workload','mixer-batch256','--seed','1',"
            "'--seconds','1']; import perfbench.harness.cell, perfbench.counts.flops; "
            "[__import__('importlib').import_module(m) for m in ('perfbench.reference.compare',"
            "'perfbench.reference.train')]; from perfbench.harness import program; "
            "print(program.forbidden_modules(list(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cfg_name", [c["name"] for c in MANIFEST["configs"]])
def test_specs_are_the_port_state_dicts(cfg_name):
    from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip_from_config
    from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
    from feed_forward_vqgan_clip_tpu_torch.models.vqgan import make_vqgan

    cfg = json.loads((ROOT / f"perfbench/configs/{cfg_name}.json").read_text())
    meta = torch.device("meta")
    c, v = cfg["clip"], cfg["vqgan"]
    specs = {"clip": {**R.clip_text_spec(c), **T.clip_image_spec(c)},
             "vqgan": R.vqgan_spec(v),
             "mapper": R.mapper_spec(cfg["mapper"], c["embed_dim"], v["embed_dim"])}
    modules = {"clip": make_clip_from_config(c, device=meta, image=True),
               "vqgan": make_vqgan(v, device=meta),
               "mapper": build_mapper(program.mapper_config(cfg), vq_channels=v["embed_dim"],
                                      device=meta)}
    for k, mod in modules.items():
        got = {n: tuple(t.shape) for n, t in mod.state_dict().items()}
        assert got == {n: tuple(s) for n, (s, _) in specs[k].items()}, k


def test_flop_counts_against_the_frozen_ones():
    cfg = json.loads((ROOT / "perfbench/configs/mixer32x1024-vitb32-f16.json").read_text())
    assert abs(flops.image_flops(cfg) / 433.0e9 - 1) < 1e-3
    assert abs(flops.train_image_flops(cfg, 8) * 8 / 9.5078e12 - 1) < 0.02
    # K4 at batch 1 is bound by its operations: 0.1737 ms
    assert abs(flops.least_seconds(*flops.mixer_stream(cfg, 1)) - 0.1737e-3) < 1e-7


def test_a_new_cell_is_found_by_name_in_added_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files and entries; nothing already there changes."""
    shutil.copytree(C.BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    cfg = json.loads((ROOT / "perfbench/configs/mixer32x1024-vitb32-f16.json").read_text())
    cfg["name"] = "mixer32x1024-other"
    (tmp_path / "perfbench/configs/mixer32x1024-other.json").write_text(json.dumps(cfg))
    (tmp_path / "perfbench/traffic/batch64.json").write_text(
        json.dumps({"generator": "batch", "batch": 64, "pool": 4, "token_ids": [300, 40000]}))
    (tmp_path / "perfbench/workloads/new-batch64.json").write_text(
        json.dumps({"sample": {}, "limits": {"text_err": 1.0}}))
    (tmp_path / "perfbench/metrics/new.launches.py").write_text(
        "def read(ctx, outcome):\n    return 42.0\n")
    manifest["configs"].append({"name": "mixer32x1024-other", "source": "x", "why": "x",
                                "file": "perfbench/configs/mixer32x1024-other.json", "reduced": []})
    manifest["workloads"].append({"name": "new-batch64", "config": "mixer32x1024-other",
                                  "traffic": "batch64", "chips": 1, "why": "x"})
    manifest["end_to_end"][0]["workloads"].append("new-batch64")
    manifest["per_layer"].append({"name": "new.launches", "unit": "1", "better": "lower",
                                  "source": "program_counter", "layer": "x",
                                  "moves": "infer_img_per_s", "workloads": ["new-batch64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = ("import sys; sys.path.insert(0, '.'); from perfbench.harness import cell as C; "
            "c = C.load_cell('new-batch64'); ctx = type('X', (), {'cell': c})(); "
            "print(c.mix['batch'], c.config['name'], [m['name'] for m in c.end_to_end], "
            "C.read_per_layer(ctx, None))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout
    assert "64 mixer32x1024-other ['infer_img_per_s', 'setup_s']" in out
    assert "'new.launches': {'value': 42.0, 'unit': '1'}" in out
