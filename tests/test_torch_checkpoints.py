"""Port checkpoints (``hocon_torch.train.checkpoints``) and the optax Adam
state bridge.

Resume must be exact: two Adam steps, a save, a restore into a fresh
state built from another seed and one more step give the bits of three
uninterrupted steps (parameters, batch-norm statistics, Adam moments and
step tensors, the per-group count, the schedule and ``state.step``). Warm
starts follow ``hocon``'s ``_merge_partial``. The optimizer bridge is held
to ``hocon``: JAX's state after two optax Adam steps continues in the port,
whose third update agrees with JAX's per tensor.
"""

import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

from hocon.data.factory import get_dataset
from hocon.data.pipeline import BatchLoader
from hocon.models.hocnet import HOCNet
from hocon.train.state import create_train_state as ref_create_train_state
from hocon.train.state import make_optimizer as ref_make_optimizer
from hocon.train.steps import make_train_step as ref_make_train_step
from hocon_torch.data.factory import get_dataset as port_get_dataset
from hocon_torch.data.pipeline import BatchLoader as PortBatchLoader
from hocon_torch.geometry.mano import synthetic_mano_model
from hocon_torch.models.hocnet import HOCNet as PortHOCNet
from hocon_torch.train.checkpoints import CheckpointManager, restore_for_warm_start
from hocon_torch.train.state import create_train_state, make_optimizer
from hocon_torch.train.steps import make_train_step
from hocon_torch.utils.flax_weights import (
    flax_to_state_dict,
    load_flax_variables,
    load_optax_adam_state,
)

torch.set_num_threads(1)

RES = 32


@pytest.fixture(scope="module")
def port_batches():
    """Three supervised batches of 4 frames (hand + object, 32 px)."""
    mano = synthetic_mano_model(0, device="cpu")
    ds = port_get_dataset("synthetic", "train", image_size=RES, use_objects=True, train=True,
                          mano=mano, synth_videos=2, synth_frames=4, device="cpu")
    loader = PortBatchLoader(ds, batch_size=4, seed=0)
    return mano, list(loader.epoch(0)) + list(loader.epoch(1))[:1]


def _port_state(seed, with_object=True):
    model = PortHOCNet(with_object=with_object, freeze_batchnorm=False, seed=seed, device="cpu")
    optimizer = make_optimizer("adam", 1e-3, lr_decay_step=2, lr_decay_gamma=0.5)
    return model, optimizer, create_train_state(model, optimizer)


def _snapshot(state) -> dict:
    """Everything a resume must reproduce, as tensors and numbers."""
    out = {f"model/{k}": v.clone() for k, v in state.model.state_dict().items()}
    for i, p in enumerate(state.model.parameters()):
        for k, v in state.optimizer.state[p].items():
            out[f"opt/{i}/{k}"] = v.clone()
    out["count"] = [g["count"] for g in state.optimizer.param_groups]
    out["lr"] = [g["lr"] for g in state.optimizer.param_groups]
    out["schedule"] = (state.schedule.last_epoch, state.schedule.get_last_lr())
    out["step"] = state.step
    return out


def test_resume_is_bit_exact(port_batches, tmp_path):
    mano, batches = port_batches
    model, opt, state = _port_state(0)
    step = make_train_step(model, mano, opt, device="cpu")
    for b in batches:
        state, _ = step(state, b)
    want = _snapshot(state)

    model, opt, state = _port_state(0)
    step = make_train_step(model, mano, opt, device="cpu")
    for b in batches[:2]:
        state, _ = step(state, b)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.save(state.step, state) and ckpt.latest_step == 2

    model, opt, fresh = _port_state(1)  # other weights, fresh optimizer and schedule
    fresh = CheckpointManager(str(tmp_path / "ckpt")).restore(fresh)
    assert fresh.step == 2
    fresh, _ = make_train_step(model, mano, opt, device="cpu")(fresh, batches[2])
    got = _snapshot(fresh)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    assert want["count"] == [3] and want["schedule"][0] == 3 and want["step"] == 3


def _tiny_state():
    return create_train_state(nn.Linear(3, 2), make_optimizer("adam", 1e-3))


def test_max_to_keep_interval_and_uncommitted_steps(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=3)
    state = _tiny_state()
    for s in (1, 2, 3, 4):
        assert ckpt.save(s, state)
    assert ckpt.all_steps() == [2, 3, 4]
    assert not ckpt.save(4, state) and not ckpt.save(3, state)  # at or below the latest
    # A step cut off while it was written, and a directory without a state,
    # are not steps.
    os.makedirs(tmp_path / ".tmp-9-1234")
    (tmp_path / ".tmp-9-1234" / "state.pt").write_bytes(b"partial")
    os.makedirs(tmp_path / "11")
    assert ckpt.latest_step == 4 and CheckpointManager(str(tmp_path)).latest_step == 4
    restored = CheckpointManager(str(tmp_path)).restore(_tiny_state())
    assert restored.step == 0  # the step count saved with the state
    every2 = CheckpointManager(str(tmp_path / "b"), save_interval_steps=2)
    assert every2.save(3, state)  # the first save is kept whatever its step
    assert not every2.save(5, state) and every2.save(6, state)
    assert every2.all_steps() == [3, 6]
    every2.wait()


def test_warm_start_transfers_across_variants(tmp_path, capsys):
    """Hand + object -> hand-only: the object head's keys are dropped and
    every other tensor loads; hand-only -> hand + object: the object head's
    keys are skipped (and counted), keeping the target's values. The
    optimizer state stays fresh."""
    _, _, src = _port_state(0)
    CheckpointManager(str(tmp_path / "ho")).save(5, src)
    model, _, dst = _port_state(1, with_object=False)
    dst = restore_for_warm_start(str(tmp_path / "ho"), dst)
    src_sd = src.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, src_sd[k]), k
    assert dst.step == 0 and not any("count" in g for g in dst.optimizer.param_groups)
    assert "skipped" not in capsys.readouterr().out

    CheckpointManager(str(tmp_path / "h")).save(1, dst)
    model, _, both = _port_state(2)
    obj_before = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("obj_head")}
    restore_for_warm_start(str(tmp_path / "h"), both)
    out = capsys.readouterr().out
    assert f"skipped {len(obj_before)} unmatched arrays" in out and "obj_head" in out
    for k, v in obj_before.items():
        assert torch.equal(model.state_dict()[k], v), k
    assert torch.equal(model.state_dict()["trunk.conv_init.weight"],
                       src_sd["trunk.conv_init.weight"])


def test_warm_start_refuses_no_match_and_empty_directory(tmp_path):
    CheckpointManager(str(tmp_path / "lin")).save(1, _tiny_state())
    _, _, state = _port_state(0, with_object=False)
    with pytest.raises(ValueError, match="zero parameter arrays"):
        restore_for_warm_start(str(tmp_path / "lin"), state)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        restore_for_warm_start(str(tmp_path / "empty"), state)


def test_optax_adam_state_continues_in_the_port(mano_model):
    """JAX: three supervised Adam steps (hand + object, 4 frames, 32 px,
    f32). Port: the weights and optax state after two, then its own third
    step on the same batch. Per tensor, the port's third update against
    JAX's at the supervised step's gradient bars, cosine 1 - 1e-6 and
    relative L2 5e-4 (measured: 1 - 1.4e-10 and 1.7e-5)."""
    ds = get_dataset("synthetic", "train", image_size=RES, use_objects=True, train=True,
                     mano=mano_model, synth_videos=2, synth_frames=4)
    loader = BatchLoader(ds, batch_size=4, seed=0)
    batches = list(loader.epoch(0)) + list(loader.epoch(1))[:1]
    net = HOCNet(with_object=True)
    tx = ref_make_optimizer("adam", 1e-3)
    state = ref_create_train_state(net, mano_model, tx, batches[0], jax.random.PRNGKey(0))
    step = ref_make_train_step(net, mano_model, tx)
    for b in batches[:2]:
        state, _ = step(state, b)
    after2 = jax.device_get({"params": state.params, "batch_stats": state.batch_stats,
                             "opt_state": state.opt_state, "step": state.step})
    state, _ = step(state, batches[2])
    after3 = flax_to_state_dict({"params": jax.device_get(state.params)})

    port = PortHOCNet(with_object=True, device="cpu")
    load_flax_variables(port, {k: after2[k] for k in ("params", "batch_stats")})
    optimizer = make_optimizer("adam", 1e-3)
    pstate = create_train_state(port, optimizer)
    adam = after2["opt_state"][0]
    load_optax_adam_state(pstate, adam.mu, adam.nu, adam.count)
    assert pstate.step == int(after2["step"]) == 2
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    pstate, _ = make_train_step(port, synthetic_mano_model(0, device="cpu"), optimizer,
                                device="cpu")(pstate, batches[2])
    assert pstate.step == 3 and pstate.optimizer.param_groups[0]["count"] == 3
    want2 = flax_to_state_dict({"params": after2["params"]})
    worst_cos, worst_rel = 1.0, 0.0
    for k, p in port.named_parameters():
        got = (p.detach() - before[k]).double().numpy()
        want = after3[k].astype(np.float64) - want2[k].astype(np.float64)
        cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)))
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert cos > 1 - 1e-6 and rel < 5e-4, (k, cos, rel)
        worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
    print(f"third update: lowest cosine 1 - {1 - worst_cos:.3g}, largest relative L2 "
          f"{worst_rel:.3g}")
    with pytest.raises(TypeError, match="OptaxAdam"):
        sgd = create_train_state(port, make_optimizer("sgd", 1e-3))
        load_optax_adam_state(sgd, adam.mu, adam.nu, adam.count)
