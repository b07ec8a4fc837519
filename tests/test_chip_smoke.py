"""chip_smoke.py's checks and comparators, rehearsed on the CPU at tiny size.

The script itself refuses to run without a GPU; these tests drive its
building blocks (engine run with donation, trajectory/invariant check,
stage comparators, the --multichip comparison) on the CPU backend.
"""

import dataclasses

import jax
import numpy as np
import pytest

import chip_smoke
from voxelhashing_tpu import checks
from voxelhashing_tpu.config import (CameraConfig, EngineConfig, FilterConfig,
                                     MapConfig, TrackerConfig)

CAM = CameraConfig(width=128, height=96, fx=104.0, fy=104.0,
                   cx=63.5, cy=47.5)
CFG = EngineConfig(
    camera=CAM,
    map=MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                  num_blocks=8192, table_size=32768,
                  max_active_blocks=4096),
    tracker=TrackerConfig(levels=2, max_outer_iter=(6, 4),
                          max_inner_iter=(1, 1),
                          dist_thres=(0.15, 0.15), normal_thres=(0.9, 0.9),
                          angle_trans_thres=(1.0, 1.0),
                          dist_trans_thres=(1.0, 1.0),
                          residual_early_out=(1e-9, 1e-9)),
    filter=FilterConfig(depth_filter=False),
    offline=False,
)
ATE_LIMIT = 0.012


@pytest.fixture(scope="module")
def tiny_run():
    frames = chip_smoke.make_frames(CAM, 5)
    return frames, chip_smoke.run_engine(CFG, frames)


@pytest.fixture(scope="module")
def stage_pair(tiny_run):
    frames, run = tiny_run
    inp = chip_smoke.stage_inputs(run["state"], frames[-1][:2],
                                  run["est"][-1], run["est"][-2], CFG)
    cpu = jax.devices("cpu")[0]
    return (inp, chip_smoke.run_stages(inp, CFG, cpu),
            chip_smoke.run_stages(inp, CFG, cpu))


@pytest.mark.parametrize("corruption", ["none", "trajectory", "invariant"])
def test_sequence_check(tiny_run, corruption):
    """A good tiny run passes; an offset trajectory or a broken map
    invariant is rejected."""
    frames, run = tiny_run
    assert len(run["times"]) == len(frames)
    ate, failures, inv = chip_smoke.check_sequence(CFG, run, frames,
                                                   ATE_LIMIT)
    if corruption == "none":
        assert failures == [], failures
        assert ate < ATE_LIMIT
        return
    if corruption == "trajectory":
        bad = dict(run, est=[np.array(p) for p in run["est"]])
        for p in bad["est"]:
            p[:3, 3] += 0.05
        _, failures, _ = chip_smoke.check_sequence(CFG, bad, frames,
                                                   ATE_LIMIT)
        assert any("ATE" in f for f in failures), failures
    else:
        _, failures = checks.check_run(
            run["est"], [f[2] for f in frames],
            [bool(g.tracking_valid) for g in run["diags"]],
            dict(inv, table_pool_mismatch=3),
            [int(g.n_allocated_blocks) for g in run["diags"]], ATE_LIMIT)
        assert any("invariant" in f for f in failures), failures


@pytest.mark.parametrize("injected", ["none", "sdf", "depth", "system"])
def test_stage_comparator(stage_pair, injected):
    """Two identical CPU runs compare with zero differences; an injected
    difference in any stage is flagged."""
    inp, a, b = stage_pair
    b = jax.tree_util.tree_map(np.array, b)      # writable copies
    n = int(inp["active_mask"].sum())
    assert n > 0
    if injected == "sdf":
        # a large error on a fused voxel that is not borderline
        w = b["weight"][:n]
        i, j = np.argwhere(w > 0)[len(np.argwhere(w > 0)) // 2]
        b["sdf"][i, j] += 0.01
    elif injected == "depth":
        fin = np.isfinite(b["depth"])
        b["depth"][fin] += np.where(np.arange(fin.sum()) % 20 == 0, 0.01, 0)
    elif injected == "system":
        # a 0.1% error in A: ten times the stated 1e-4 tolerance
        b["system"] = (b["system"][0] * 1.001,) + tuple(b["system"][1:])
    res = chip_smoke.compare_stages(a, b, inp, CFG)
    if injected == "none":
        assert all(v["ok"] for v in res.values()), res
        assert res["integrate"]["differing"] == 0
        assert res["render"]["differing"] == 0
        assert res["icp_system"]["rel_err"] == 0.0
    else:
        key = {"sdf": "integrate", "depth": "render",
               "system": "icp_system"}[injected]
        assert not res[key]["ok"], res[key]
        assert all(v["ok"] for k, v in res.items() if k != key), res


def test_integrate_matches_numpy_reference(stage_pair):
    """The XLA integrate agrees with checks.integrate_reference (the plain
    f32 NumPy twin bench.py checks against) within compare_voxels'
    tolerance, and the comparison is not vacuous."""
    inp, a, _ = stage_pair
    rows = inp["active_idx"][inp["active_mask"]]
    m = inp["map"]
    ref_s, ref_w, border = checks.integrate_reference(
        m.block_key[rows], np.asarray(m.sdf[rows], np.float32),
        np.asarray(m.weight[rows], np.float32), inp["depth"], inp["color"],
        inp["pose"], CAM, CFG.map)
    n = len(rows)
    res = checks.compare_voxels(a["sdf"][:n], a["weight"][:n],
                                checks.to_bf16_f32(ref_s),
                                checks.to_bf16_f32(ref_w), border)
    assert res["ok"], res
    old_w = np.asarray(m.weight[rows], np.float32)
    assert (ref_w != old_w).sum() > 1000     # the frame did fuse


def test_multichip_comparison_on_virtual_devices():
    """The --multichip comparison at tiny size on 4 of the 8 virtual CPU
    devices: the sharded map agrees with the single-device run."""
    devs = jax.devices()
    assert len(devs) >= 4, devs
    cfg = dataclasses.replace(CFG, map=dataclasses.replace(
        CFG.map, num_blocks=16384, table_size=65536,
        max_active_blocks=8192))
    frames = chip_smoke.make_frames(CAM, 4)
    res = chip_smoke.multichip_compare(cfg, frames, devs[:4])
    assert res["failures"] == [], res
    assert len(res["blocks_per_shard"]) == 4
    assert min(res["blocks_per_shard"]) > 0
