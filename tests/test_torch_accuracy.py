"""The port's accuracy driver (swarm_tpu_torch/accuracy.py), the
counterpart of tools/bench_accuracy.py, on the CPU.

1. The host metrics (`true_wall_mask`, `dilate`, `wall_metrics`, `ate`)
   equal the tool's on the 8-agent accuracy world and a map made from a
   seed.
2. `reraster_from_poses` against the tool's (the JAX XLA beam tier,
   jitted) on 6 steps of 4 agents' sweeps: decision-equal maps.
3. `python -m swarm_tpu_torch.accuracy --agents 4 --steps 20` (chunks of
   10): every tier present with the tool's keys, every number finite.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from swarm_tpu_torch import accuracy, presets
from tests.torch_parity import decision_equal
from tests.torch_parity import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import bench_accuracy as tool  # noqa: E402  (the tool, by path)

# the tool's keys per tier (tools/bench_accuracy.py:324-589)
WALL = {"wall_p50", "wall_p90", "wall_iou", "occ_cells"}
KEYS = {
    **{v: {"ate_mean_m", "ate_late_m", "closures", "merges"} | WALL
       for v in presets.ACCURACY_VARIANTS},
    "refined": {"ate_mean_m", "ate_late_m", "closures_used",
                "measured_edges"},
    "joint": {"ate_mean_m", "ate_late_m", "components", "inter_edges"},
    "calibrated": {"ate_mean_m", "ate_late_m", "bias_hat_mean_abs",
                   "merge_obs"} | WALL,
    "calibrated_robust": {"ate_mean_m", "ate_late_m", "merge_obs"} | WALL,
    "calibrated_reloc": {"ate_mean_m", "ate_late_m", "reloc_obs",
                         "bias_hat_mean_abs"} | WALL,
    **{k: {"ate_mean_m", "ate_late_m", "merge_obs"} | WALL
       for k in ("anchored_gn", "calibrated_gn", "reloc_gn")},
    **{k: {"ate_mean_m", "ate_late_m", "merge_obs", "inter_edges",
           "components"} | WALL
       for k in ("anchored_joint", "calibrated_joint", "reloc_joint")},
}


def test_host_metrics_equal_the_tools():
    cfg, walls, _, _ = presets.accuracy(8, "raw", device="cpu")
    w = walls.numpy()
    mask = accuracy.true_wall_mask(w, cfg.grid)
    np.testing.assert_array_equal(mask, tool.true_wall_mask(w, cfg.grid))
    rng = np.random.default_rng(0)
    occ = accuracy.dilate(mask, 1) & (rng.random(mask.shape) < 0.5)
    occ |= rng.random(mask.shape) < 0.001
    np.testing.assert_array_equal(accuracy.dilate(occ, 2),
                                  tool.dilate(occ, 2))
    assert accuracy.wall_metrics(occ, mask) == tool.wall_metrics(occ, mask)
    err = rng.random(37)
    assert accuracy.ate(err) == tool.ate(err)


def test_reraster_from_poses_matches_the_tool():
    import jax
    from __graft_entry__ import _cfg_and_world

    cfg_j = _cfg_and_world(4, frontiers=False, parity=False,
                           raster_mode="beam", use_pallas=True,
                           scan_rays=181, tiled=True)[0]
    cfg, _, params, rooms = presets.accuracy(4, "merge_anchored",
                                             device="cpu")
    rng = np.random.default_rng(1)
    t, n = 6, 4
    poses = np.stack([
        params.home_x.numpy()[None] + rng.uniform(0, 0.5, (t, n)),
        params.home_y.numpy()[None] + rng.uniform(0, 0.5, (t, n)),
        rng.uniform(-np.pi, np.pi, (t, n))], -1).astype(np.float32)
    scans = rng.uniform(0.02, 1.4, (t, n, 181)).astype(np.float32)
    ref = tool.reraster_from_poses(poses, scans, cfg_j, chunk=3)
    got = accuracy.reraster_from_poses(poses, scans, cfg, chunk=3,
                                       device="cpu")
    decision_equal(got, ref, "reraster")
    assert int((ref != 0).sum()) > 1000
    assert jax.devices()[0].platform == "cpu"


def test_driver_every_tier_finite_with_the_tools_keys(tmp_path):
    out_json = tmp_path / "acc.json"
    proc = subprocess.run(
        [sys.executable, "-m", "swarm_tpu_torch.accuracy", "--agents", "4",
         "--steps", "20", "--chunk", "10", "--device", "cpu", "--json",
         str(out_json)], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(out_json.read_text())
    assert set(out) >= {"agents", "steps", "platform", "drift", "variants"}
    assert out["agents"] == 4 and out["steps"] == 20
    assert out["platform"] == "cpu"
    assert list(out["variants"]) == list(accuracy.TIERS)
    for tier, keys in KEYS.items():
        got = out["variants"][tier]
        assert set(got) == keys, (tier, sorted(got))
        for k, v in got.items():
            for x in np.ravel(v):
                assert np.isfinite(float(x)), (tier, k, v)
    assert set(out["timing"]["steps_per_s"]) == \
        set(presets.ACCURACY_VARIANTS)
    assert out["variants"]["merge_anchored"]["merges"] > 0
    assert "steps/s" in proc.stdout


def test_worlds_are_the_presets_and_the_noise_is_drawn_on_the_cpu():
    """`worlds` gives `presets.accuracy` per variant; `run_variants` draws
    its noise from a CPU generator seeded 0, so two runs log the same
    values (and a run on the card sees the CPU run's noise)."""
    got = accuracy.worlds(2, "cpu", pair_budget=3)
    assert list(got) == list(presets.ACCURACY_VARIANTS)
    for v, (cfg, walls, _, _) in got.items():
        ref = presets.accuracy(2, v, device="cpu", pair_budget=3)
        assert cfg == ref[0] and torch.equal(walls, ref[1])
    one = {"raw": got["raw"]}
    runs = [accuracy.run_variants(one, 3, 3, log=lambda m: 0)[1]["raw"][0]
            for _ in range(2)]
    for k in accuracy.LOG_KEYS:
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)
