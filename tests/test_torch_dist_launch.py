"""``launch.train --mesh 2x2 --devices 4 --device cpu --smoke`` on four gloo
ranks, its resume, and the elastic restore of its checkpoint onto two
ranks (``tests/test_dist.py:316``). Helpers: ``tests/test_torch_dist.py``.
"""
import numpy as np

from repro_torch.launch.mesh import spawn
from test_torch_dist import _cfg, _restored_summary


def _restore_rank(rank, ckpt_dir):
    """Two ranks, a (1, 2) mesh: the launcher's 4-rank checkpoint restored."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.sharding import to_named, use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.step import TrainConfig, init_train_state, train_state_pspecs
    from repro_torch.train.trainer import Trainer, TrainerConfig

    mesh = make_mesh((1, 2), ("data", "model"), device_type="cpu")
    tr = Trainer(_cfg("qwen3-0.6b", "bfloat16"), DataConfig(batch=4, seq_len=32),
                 TrainConfig(total_steps=6, warmup=1),
                 TrainerConfig(total_steps=6, ckpt_every=100, ckpt_dir=ckpt_dir, log_every=100),
                 mesh=mesh, device="cpu")
    state = init_train_state(tr.api, tr.optimizer, 0)
    with use_mesh(mesh):
        step, restored, _ = tr.ckpt.restore_latest(
            state, to_named(train_state_pspecs(state, mesh), mesh))
        summary = _restored_summary(step, restored, mesh, {"data": 1, "model": 2})
    return summary


def test_launch_train_on_a_mesh_then_restore_on_fewer_ranks(tmp_path, capsys):
    """``launch.train --mesh 2x2 --devices 4 --device cpu --smoke`` trains
    with a falling loss and resumes from its checkpoint; the checkpoint its
    4 ranks wrote restores onto 2 (``tests/test_dist.py:316``)."""
    from repro_torch.launch import train as launch_train

    ckpt = str(tmp_path / "ckpt")

    def argv(steps):
        return ["--arch", "qwen3-0.6b", "--smoke", "--steps", str(steps), "--batch", "4",
                "--seq", "32", "--ckpt-dir", ckpt, "--ckpt-every", "2", "--mesh", "2x2",
                "--devices", "4", "--device", "cpu"]

    assert launch_train.main(argv(2)) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    first, last = (float(x) for x in line.split("loss ")[1].split(" -> "))
    assert line.startswith("finished at step 2") and last < first
    step, losses = launch_train.run(launch_train.parse_args(argv(3)))
    assert step == 3 and len(losses) == 1  # resumed at step 2: step 3 ran
    results = spawn(_restore_rank, 2, (ckpt,), store_path=str(tmp_path / "store"), timeout=300)
    for r in results:
        assert r["step"] == 3 and r["opt_step"] == 3
        assert r["placed"] and r["mu_dtensor"] and r["bad_shapes"] == []
        np.testing.assert_array_equal(r["first"], results[0]["first"])
