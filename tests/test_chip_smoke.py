"""chip_smoke.py and bench.py off the card: both refuse to run without a
GPU, the smoke's phase selection and result line, and every smoke phase
at a tiny size on the CPU (the same code the card runs at full size)."""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _run_cpu(script, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, os.path.join(ROOT, script),
                           *args], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_chip_smoke_refuses_without_gpu(args):
    r = _run_cpu("chip_smoke.py", *args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_bench_refuses_without_gpu():
    r = _run_cpu("bench.py")
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_chip_smoke_last_line_format():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H200")] * 4
    line = chip_smoke.last_line(devs)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H200", "count": 4}}
    assert "\n" not in line


def test_chip_smoke_four_cards_selects_dist_only():
    assert [f for _, f in chip_smoke.phases(True)] == [chip_smoke.phase_dist]
    single = [f for _, f in chip_smoke.phases(False)]
    assert chip_smoke.phase_dist not in single
    assert chip_smoke.phase_kv in single and chip_smoke.phase_join in single


def test_chip_smoke_check_rejects_mismatch():
    import numpy as np
    with pytest.raises(AssertionError):
        chip_smoke.check("x", [np.arange(4, dtype=np.uint32)],
                         [np.arange(1, 5, dtype=np.uint32)])
    # floats compare by their bits: -0.0 is not 0.0
    with pytest.raises(AssertionError):
        chip_smoke.check("f", [np.array([-0.0], np.float32)],
                         [np.array([0.0], np.float32)])


SMALL = {
    "copy": dict(n=1 << 12),
    "keys sort": dict(n=1 << 12, n_codec=1 << 10),
    "stable kv": dict(n=10_007),
    "filter + group by": dict(n=10_000, groups=64),
    "hash join": dict(nb=1000, npr=10_000),
    "top-k / distinct": dict(n=1 << 14, k=100),
}


@pytest.mark.parametrize("name", list(SMALL))
def test_chip_smoke_phase_small(name):
    dict(chip_smoke.phases(False))[name](**SMALL[name])


def test_chip_smoke_dist_phase_small():
    assert len(jax.devices()) >= 4
    chip_smoke.phase_dist(n_kv=1 << 14, n_query=10_000, groups=64,
                          nb=1000, npr=10_000, cards=4)
