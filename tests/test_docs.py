"""Execute the documentation's fenced python blocks so the docs cannot rot
(the reference runs doctests via Documenter, e.g. src/circuit.jl:165-173).

Blocks within one document share a namespace (they build on each other).
Long-running constants are shrunk via a light source rewrite (44100-sample
runs become 441) -- the point is API liveness, not timing -- on the CPU
test mesh.
"""

import re
from pathlib import Path

import numpy as np
import pytest

DOCS = Path(__file__).resolve().parent.parent / "docs"


def _python_blocks(path):
    text = path.read_text()
    return re.findall(r"```python\n(.*?)```", text, re.S)


def _shrink(src):
    # 1 s of audio -> 10 ms; keeps shapes/semantics, drops 100x runtime
    return src.replace("np.arange(44100)", "np.arange(441)")


def test_gettingstarted_blocks_run():
    blocks = _python_blocks(DOCS / "gettingstarted.md")
    assert blocks, "gettingstarted.md lost its python examples"
    ns = {}
    for src in blocks:
        exec(compile(_shrink(src), "gettingstarted.md", "exec"), ns)
    assert np.asarray(ns["y"]).shape[-1] == 441


def test_gpu_guide_blocks_run():
    from acme_tpu.models import diodeclipper_model

    blocks = _python_blocks(DOCS / "gpu.md")
    assert blocks, "gpu.md lost its python examples"

    # the guide's snippets assume a model/u from the getting-started flow;
    # provide a tiny stand-in model (no pot inputs) on the CPU test mesh
    model = diodeclipper_model()
    T = 64
    u = 0.4 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T))[None, :]
    ns = {"model": model, "u": u, "u_time": u, "np": np}
    for src in blocks:
        src = src.replace(
            "run_sweep(u_time, lane_values, lane_input_idx=(1, 2))",
            "run_sweep(u_time, np.zeros((8, 0)), lane_input_idx=())")
        src = src.replace(
            "sharded_run_sweep(cm, u_time, lane_values, (1, 2), mesh)",
            "sharded_run_sweep(cm, u_time, np.zeros((8, 0)), (), mesh)")
        exec(compile(src, "gpu.md", "exec"), ns)
    assert np.asarray(ns["y"]).shape[-1] == T


def test_readme_quickstart_runs():
    """The README's quickstart block must stay executable too (API
    liveness, not timing)."""
    readme = DOCS.parent / "README.md"
    blocks = _python_blocks(readme)
    assert blocks, "README lost its python quickstart"
    ns = {}
    for src in blocks:
        exec(compile(_shrink(src), "README.md", "exec"), ns)
    assert np.asarray(ns["y"]).shape[-1] == 441
