"""PyTorch port: the trainer on a mesh, and the data axis across processes.

A mesh step (each data slot runs the forward and backward of its shard
with its own replica, the loss taken over the whole gathered batch, the
gradients summed on the first slot, one clip and AdamW there, the
parameters copied back) is held to the unsharded step within f32
round-off: losses to 1e-6 relative, gradients to 1e-5 of their largest,
parameters to 1e-6. The two-process case mirrors tests/test_multihost.py:
``maybe_initialize_distributed`` from the reference's environment variables
(gloo on the CPU), a data axis of two slots in each of two processes, and
the cross-process ``all_reduce`` inside the train step."""

import os
import socket
import subprocess
import sys

import pytest
import torch

from image_restoration_platform_tpu_torch.parallel import make_mesh
from image_restoration_platform_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(family: str, **kw) -> TrainConfig:
    return TrainConfig(family=family, batch_size=4, image_size=32, compute_dtype=torch.float32,
                       total_steps=100, warmup_steps=2, seed=3, **kw)


def _two_steps(trainer: Trainer):
    losses, grads = [], []
    for _ in range(2):
        losses.append(float(trainer.step_fn(trainer.state, *trainer.next_batch())))
        grads.append({k: p.grad.clone() for k, p in trainer.state.model.named_parameters()})
    return losses, grads, {k: p.detach() for k, p in trainer.state.model.named_parameters()}


@pytest.mark.parametrize(
    "family,axes,kw",
    [
        ("restore-unet-small", dict(data=2), {}),
        ("restore-unet-small", dict(data=2, tensor=2), {"anchor_comp": 0.5}),
        ("restore-unet-small", dict(data=4), {"remat": True}),
        ("sr-x2", dict(data=4), {}),
        ("diffusion-restore", dict(data=2), {}),
    ],
    ids=["restore-data2", "restore-data2-tensor2", "restore-data4-remat", "sr-data4", "diffusion-data2"],
)
def test_mesh_step_equals_the_unsharded_step(family, axes, kw):
    cfg = _config(family, **kw)
    slots = 1
    for size in axes.values():
        slots *= size
    plain = Trainer(cfg, device="cpu")
    meshed = Trainer(cfg, mesh=make_mesh([CPU] * slots, **axes))
    assert meshed.device == CPU and len(meshed.state.replicas) == axes["data"]
    # slots that repeat the model's device run the model itself; column-parallel rows run copies
    shared = [r is meshed.state.model for r in meshed.state.replicas]
    assert shared == [axes.get("tensor", 1) == 1] * axes["data"]
    losses_p, grads_p, params_p = _two_steps(plain)
    losses_m, grads_m, params_m = _two_steps(meshed)
    for a, b in zip(losses_m, losses_p):
        assert abs(a - b) <= 1e-6 * abs(b), (losses_m, losses_p)
    for gm, gp in zip(grads_m, grads_p):
        peak = max(float(g.abs().max()) for g in gp.values())
        worst = max(float((gm[k] - gp[k]).abs().max()) for k in gp)
        assert worst <= 1e-5 * peak + 1e-12, (worst, peak)
    assert max(float((params_m[k] - params_p[k]).abs().max()) for k in params_p) <= 1e-6
    # the replicas hold the updated parameters
    from image_restoration_platform_tpu_torch.parallel.sharding import gather_state

    for replica in meshed.state.replicas:
        state = gather_state(replica, CPU)
        assert all(torch.equal(state[k], v) for k, v in params_m.items())


def test_mesh_trainer_refuses_an_uneven_split():
    meshed = Trainer(_config("sr-x2"), mesh=make_mesh([CPU] * 3, data=3))
    with pytest.raises(ValueError, match="not divisible"):
        meshed.step_fn(meshed.state, *meshed.next_batch())


_WORKER = r"""
import os
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from image_restoration_platform_tpu_torch.parallel import make_mesh, maybe_initialize_distributed
from image_restoration_platform_tpu_torch.train.trainer import TrainConfig, Trainer

assert maybe_initialize_distributed() and maybe_initialize_distributed()  # idempotent
rank = int(os.environ["JAX_PROCESS_ID"])
assert dist.get_world_size() == 2 and dist.get_rank() == rank and dist.get_backend() == "gloo"
total = torch.tensor([float(rank + 1)])
dist.all_reduce(total)
assert float(total) == 3.0, float(total)

cfg = TrainConfig(family="restore-unet-small", batch_size=8, image_size=32, compute_dtype=torch.float32,
                  total_steps=100, warmup_steps=2, seed=5, anchor_comp=0.5)
# a data axis of 2 slots here, 2 more in the other process: 2 images a slot
meshed = Trainer(cfg, mesh=make_mesh([torch.device("cpu")] * 2, data=2))
plain = Trainer(cfg, device="cpu")
for _ in range(2):
    lm = float(meshed.step_fn(meshed.state, *meshed.next_batch()))
    lp = float(plain.step_fn(plain.state, *plain.next_batch()))
    assert abs(lm - lp) <= 1e-6 * abs(lp), (lm, lp)
pm = dict(meshed.state.model.named_parameters())
worst = max(float((pm[k] - p).abs().max()) for k, p in plain.state.model.named_parameters())
assert worst <= 1e-6, worst
# both processes hold the same parameters
flat = torch.cat([p.detach().reshape(-1) for p in pm.values()])
other = [torch.empty_like(flat) for _ in range(2)]
dist.all_gather(other, flat)
assert torch.equal(other[0], other[1])
dist.destroy_process_group()
print(f"worker {rank} ok", flush=True)
"""


def test_two_process_data_axis_train_step():
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()
    procs = []
    for pid in range(2):
        env = dict(os.environ, JAX_COORDINATOR=coord, JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"worker {pid} ok" in out
