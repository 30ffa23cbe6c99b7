"""chip_smoke.py refuses to report anything without a GPU or outside a
checkout (it runs on the card; see the README)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    p = _run(script, tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_placement(tmp_path, monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache; otherwise the
    fixed directory inside the checkout."""
    import jax

    from acme_tpu.utils import cache

    saved = jax.config.jax_compilation_cache_dir
    default = cache.CACHE_DIR
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(cache, "CACHE_DIR", str(tmp_path / "fixed"))
        want = str(tmp_path / "fixed")
    try:
        assert cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    assert Path(default) == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text()


def test_chip_smoke_window_and_parity_summary():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    args = chip_smoke.smoke_args("--seconds",
                                 str(chip_smoke.WINDOW / 44100))
    assert int(round(args.seconds * args.fs)) == chip_smoke.WINDOW
    s = chip_smoke.summarize([-120.0, -101.0, -90.0, -130.0],
                             [False, False, True, False])
    assert s["worst_non_stress_db"] == -101.0
    assert s["stress_lanes_db"] == [-90.0]
    with pytest.raises(chip_smoke.PhaseError, match="boom"):
        chip_smoke.check(False, "boom")


def test_chip_smoke_parity_lanes_come_from_the_committed_cache():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    sel, stress, refs, lv = chip_smoke.parity_lanes(chip_smoke.smoke_args())
    assert len(sel) == len(refs) == 18 and sum(stress) == 2
    assert lv.shape == (18, 2)
