"""The session CLI (swarm_tpu_torch/cli/run_session.py) against the JAX
package's (swarm_tpu/cli/run_session.py), on the CPU.

The scripted preset (scenario -> CSV -> replay) writes the files JAX's
CLI writes, byte for byte, with the same metrics (the write count and the
closures equal; the timing keys aside) and the same map.png pixels. The
closed-loop presets (`dual_bot`, `swarm`) draw their own noise, so they
are held to JAX's schema: the same files, the same CSV headers and
metrics keys, one packet per live agent and step. --checkpoint / --resume
through the CLI continue a run bit for bit.
"""

import filecmp
import io
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from swarm_tpu.cli.run_session import main as j_main
from swarm_tpu_torch.cli.run_session import main as p_main
from swarm_tpu_torch.engine.checkpoint import _paths

SCRIPTED_FILES = ("telemetry.csv", "pointcloud.csv", "slam_closures.csv",
                  "pointcloud_merged.csv")
TIMING = ("elapsed_s", "steps_per_s", "replay_elapsed_s")


def _pixels(path):
    with open(path, "rb") as f:
        return np.asarray(Image.open(io.BytesIO(f.read())).convert("RGB"))


def _metrics(d):
    with open(os.path.join(d, "metrics.json")) as f:
        return json.load(f)


def _header(path):
    with open(path) as f:
        return f.readline()


def test_scripted_preset_equals_jax(tmp_path):
    jax.config.update("jax_platforms", "cpu")
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    j_main(["--preset", "dual_bot_scripted", "--out", dj])
    p_main(["--preset", "dual_bot_scripted", "--out", dp,
            "--device", "cpu"])
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dp))
    for fn in SCRIPTED_FILES:
        assert filecmp.cmp(os.path.join(dj, fn), os.path.join(dp, fn),
                           shallow=False), fn
    mj, mp = _metrics(dj), _metrics(dp)
    assert mj.keys() == mp.keys()
    for k in mj:
        if k not in TIMING:
            assert mp[k] == mj[k], k
    assert mp["closures"] > 0 and mp["packets"] == 698
    np.testing.assert_array_equal(_pixels(os.path.join(dp, "map.png")),
                                  _pixels(os.path.join(dj, "map.png")))


def test_scripted_optimize_writes_the_refined_map(tmp_path):
    d = str(tmp_path / "s")
    _, m = p_main(["--preset", "dual_bot_scripted", "--out", d,
                   "--device", "cpu", "--optimize"])
    assert os.path.getsize(os.path.join(d, "map_refined.png")) > 0
    assert set(m["refined_closures_per_agent"]) == {1, 2}
    assert _metrics(d) == json.loads(json.dumps(m))


@pytest.mark.parametrize("preset", ["dual_bot", "swarm"])
def test_closed_loop_schema_equals_jax(preset, tmp_path):
    jax.config.update("jax_platforms", "cpu")
    dp = str(tmp_path / "port")
    args = ["--preset", preset, "--steps", "10", "--agents", "8"]
    _, mp = p_main(args + ["--out", dp, "--device", "cpu"])
    steps_agents = 10 * mp["agents"]
    assert mp["packets"] == steps_agents
    assert mp["agents"] == (2 if preset == "dual_bot" else 8)
    if preset == "dual_bot":
        # JAX's CLI on the same preset (the swarm preset's world is the
        # same builder's; one JAX compile of the rollout per file is
        # enough)
        dj = str(tmp_path / "jax")
        j_main(args + ["--out", dj])
        assert sorted(os.listdir(dj)) == sorted(os.listdir(dp))
        for fn in os.listdir(dj):
            if fn.endswith(".csv"):
                assert _header(os.path.join(dp, fn)) == \
                    _header(os.path.join(dj, fn)), fn
        assert _metrics(dj).keys() == mp.keys()
        assert _metrics(dj)["packets"] == mp["packets"]
    img = _pixels(os.path.join(dp, "map.png"))
    assert img.shape[0] == img.shape[1] >= 1000
    with open(os.path.join(dp, "events.jsonl")) as f:
        for line in f:
            assert json.loads(line)["event"] in ("loop_closure",
                                                 "heartbeat",
                                                 "mission_complete")


def test_checkpoint_resume_through_the_cli(tmp_path):
    common = ["--preset", "dual_bot", "--device", "cpu", "--seed", "3"]
    full, _ = p_main(common + ["--steps", "30", "--out",
                               str(tmp_path / "full")])
    ck = str(tmp_path / "ck.npz")
    p_main(common + ["--steps", "15", "--out", str(tmp_path / "a"),
                     "--checkpoint", ck])
    done, m = p_main(common + ["--steps", "15", "--out",
                               str(tmp_path / "b"), "--resume", ck])
    assert int(done.step) == 30 and m["packets"] == 30
    for (k, a), (_, b) in zip(_paths(done), _paths(full)):
        assert torch.equal(a, b), k
