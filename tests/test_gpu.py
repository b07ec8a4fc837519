"""Card-only checks: the tiny engine run and its XLA stages on a GPU
against the CPU backend.

Marked ``gpu``; the ``gpu`` fixture decides at run time and skips where
JAX has no GPU. Run them on a machine with a card:
``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``.
"""

import jax
import pytest

import chip_smoke
from test_chip_smoke import ATE_LIMIT, CAM, CFG


@pytest.fixture(scope="module")
def gpu():
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "tests -m gpu")
    return devs[0]


@pytest.mark.gpu
def test_tiny_run_and_stages_on_gpu(gpu):
    """A tiny tracked run on the card passes chip_smoke's sequence check,
    and its integrate / tracking render / ICP system agree with the CPU
    backend within checks.py's tolerances."""
    frames = chip_smoke.make_frames(CAM, 5)
    with jax.default_device(gpu):
        run = chip_smoke.run_engine(CFG, frames)
    assert run["state"].pose.devices() == {gpu}
    _, failures, _ = chip_smoke.check_sequence(CFG, run, frames, ATE_LIMIT)
    assert failures == [], failures
    inp = chip_smoke.stage_inputs(run["state"], frames[-1][:2],
                                  run["est"][-1], run["est"][-2], CFG)
    res = chip_smoke.compare_stages(
        chip_smoke.run_stages(inp, CFG, gpu),
        chip_smoke.run_stages(inp, CFG, jax.devices("cpu")[0]), inp, CFG)
    assert all(v["ok"] for v in res.values()), res
