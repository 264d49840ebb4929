"""Port weight importer (``hocon_torch.utils.torch_import``) vs ``hocon``'s.

torchvision-named ResNet-18 / ResNet-50 feature extractors are built here
and filled with ``tools/torch_weights.py``'s weights, drawn from a numpy
seed with random batch-norm statistics (no torchvision, no download). The
port's imports must give, bit for bit, the weights of
``hocon.utils.torch_import``'s imports carried across by
``load_flax_variables`` from the same starting weights, and the port's
features and heads must match the torch net and the reference head math
(atol 2e-4 for ResNet-18 and the heads, 5e-4 for ResNet-50: the JAX test's
bars, ``tests/test_torch_import.py``). Then the CLI flags on the CPU:
``evaluate --torch_ckpt``, ``train --torch_trunk --lr 0`` and a
``--resume`` that overrides the import.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hocon.models.backbone import resnet18 as ref_resnet18
from hocon.models.backbone import resnet50 as ref_resnet50
from hocon.models.hocnet import HOCNet as RefHOCNet
from hocon.utils import torch_import as ref_import
from hocon_torch.cli import evaluate, train
from hocon_torch.cli.train import apply_torch_init
from hocon_torch.geometry.mano import synthetic_mano_model
from hocon_torch.models.backbone import resnet18, resnet50
from hocon_torch.models.hocnet import HOCNet
from hocon_torch.utils import torch_import
from hocon_torch.utils.flax_weights import flax_to_state_dict, load_flax_variables
from tools.torch_weights import reference_checkpoint, torchvision_resnet

torch.set_num_threads(1)

RES = 64
SMALL = ["--dataset", "synthetic", "--image_size", "32", "--synth_videos", "2",
         "--synth_frames", "4", "--batch_size", "4", "--no_bf16", "--epochs", "1"]


class _TvBlock(nn.Module):
    """torchvision's BasicBlock (2 convs) or Bottleneck (3 convs) names."""

    def __init__(self, cin, width, stride, bottleneck):
        super().__init__()
        cout = width * 4 if bottleneck else width
        if bottleneck:
            convs = [(cin, width, 1, 1, 0), (width, width, 3, stride, 1), (width, cout, 1, 1, 0)]
        else:
            convs = [(cin, width, 3, stride, 1), (width, width, 3, 1, 1)]
        self.n = len(convs)
        for i, (a, b, k, s, p) in enumerate(convs, start=1):
            setattr(self, f"conv{i}", nn.Conv2d(a, b, k, s, p, bias=False))
            setattr(self, f"bn{i}", nn.BatchNorm2d(b))
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = x
        for i in range(1, self.n + 1):
            y = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(y))
            if i < self.n:
                y = torch.relu(y)
        return torch.relu(idt + y)


class _TvResNet(nn.Module):
    """torchvision-named ResNet feature extractor (``fc`` included, unused)."""

    def __init__(self, sizes=(2, 2, 2, 2), bottleneck=False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for li, (w, n) in enumerate(zip((64, 128, 256, 512), sizes)):
            blocks = []
            for b in range(n):
                blocks.append(_TvBlock(cin, w, (1 if li == 0 else 2) if b == 0 else 1,
                                       bottleneck))
                cin = w * 4 if bottleneck else w
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, 1000)

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for li in range(4):
            x = getattr(self, f"layer{li + 1}")(x)
        return x.mean(dim=(2, 3))


def tv_resnet(seed: int, sizes=(2, 2, 2, 2), bottleneck=False) -> _TvResNet:
    """A torchvision-named ResNet in eval mode holding
    ``tools.torch_weights.torchvision_resnet(seed, ...)``."""
    net = _TvResNet(sizes, bottleneck).eval()
    net.load_state_dict(torchvision_resnet(seed, sizes, bottleneck))
    return net


def reference_state_dict(seed: int = 0, with_obj: bool = True) -> dict:
    """``tools.torch_weights.reference_checkpoint(seed)`` (its trunk is
    ``tv_resnet(seed)``'s), without the object branch unless ``with_obj``."""
    return {k: v for k, v in reference_checkpoint(seed).items()
            if with_obj or not k.startswith("obj_branch.")}


def _np(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


def _state_dict_np(module: nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def assert_bit_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _images(seed: int, n: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, RES, RES, 3)).astype(np.float32)


# --- the trunk ------------------------------------------------------------------

TRUNKS = {  # case: (sizes, bottleneck, hocon builder, port builder, feature atol)
    "resnet18": ((2, 2, 2, 2), False, ref_resnet18, resnet18, 2e-4),
    "resnet50": ((3, 4, 6, 3), True, ref_resnet50, resnet50, 5e-4),
}


@pytest.mark.parametrize("case", list(TRUNKS))
def test_trunk_import_matches_reference(case):
    """The imported trunk equals ``hocon``'s import carried across, bit for
    bit, and its features match the torchvision-named net."""
    sizes, bottleneck, ref_builder, port_builder, atol = TRUNKS[case]
    net = tv_resnet(1, sizes, bottleneck)
    sd = _np(net.state_dict())
    x = _images(2)

    ref_model = ref_builder(freeze_batchnorm=True)
    variables = ref_model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params, stats = ref_import.import_resnet_trunk(
        sd, variables["params"], variables["batch_stats"], stage_sizes=sizes)
    want = flax_to_state_dict({"params": params, "batch_stats": stats})

    trunk = port_builder(freeze_batchnorm=True).eval()
    load_flax_variables(trunk, jax.device_get(variables))  # the same starting weights
    torch_import.import_resnet_trunk(sd, trunk, stage_sizes=sizes)
    assert_bit_equal(_state_dict_np(trunk), want)

    with torch.no_grad():
        feats = trunk(torch.from_numpy(x)).numpy()
        tv = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(feats, tv, atol=atol)


def test_trunk_import_keeps_the_parameter_objects():
    """The copy is in place: an optimizer built before the import holds the
    imported tensors."""
    trunk = resnet18()
    before = [id(p) for p in trunk.parameters()]
    opt = torch.optim.Adam(trunk.parameters())
    sd = tv_resnet(3).state_dict()
    torch_import.import_resnet_trunk(sd, trunk)
    assert [id(p) for p in trunk.parameters()] == before
    assert opt.param_groups[0]["params"][0] is trunk.conv_init.weight
    assert torch.equal(trunk.conv_init.weight, sd["conv1.weight"])
    assert torch.equal(trunk.blocks[2].norm_proj.running_var, sd["layer2.0.downsample.1.running_var"])


# --- the full model ---------------------------------------------------------------

@pytest.fixture(scope="module")
def port_mano():
    return synthetic_mano_model(0, device="cpu")


def _models(mano_model, with_object=True, obj_rot_param="axisang", z_init=0.6):
    """``hocon``'s HOCNet with its initial variables, and the port's HOCNet
    holding the same weights."""
    ref = RefHOCNet(with_object=with_object, obj_rot_param=obj_rot_param,
                    freeze_batchnorm=True, z_init=z_init)
    x = _images(4)
    k = np.tile(np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1.0]], np.float32), (2, 1, 1))
    obj = np.random.default_rng(5).uniform(-0.03, 0.03, (2, 8, 3)).astype(np.float32)
    variables = jax.device_get(ref.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(k), mano_model,
        jnp.asarray(obj) if with_object else None))
    port = HOCNet(with_object=with_object, obj_rot_param=obj_rot_param,
                  freeze_batchnorm=True, z_init=z_init, device="cpu").eval()
    load_flax_variables(port, variables)
    return ref, variables, port, (x, k, obj)


def _lin(sd, name, h):
    return h @ sd[name + ".weight"].T + sd[name + ".bias"]


def test_full_checkpoint_import_matches_reference(mano_model, port_mano):
    """A full reference checkpoint (axis-angle object rotation): the port's
    state dict equals ``hocon``'s ``import_hocnet(..., model=...)`` carried
    across, bit for bit, and its heads compute the reference's raw
    regressions within 2e-4."""
    sd = reference_state_dict(0)
    ref, variables, port, (x, k, obj) = _models(mano_model)
    want = flax_to_state_dict(ref_import.import_hocnet(variables, _np(sd), model=ref))
    torch_import.import_hocnet(port, sd)
    assert_bit_equal(_state_dict_np(port), want)

    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(k), port_mano, torch.from_numpy(obj))
        feats = tv_resnet(0)(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    s = _np(sd)
    base = np.maximum(_lin(s, "mano_branch.base_layer.2",
                           np.maximum(_lin(s, "mano_branch.base_layer.0", feats), 0)), 0)
    pose = _lin(s, "mano_branch.pose_reg", base)
    abase = np.maximum(_lin(s, "absolute_branch.base_layer.0", feats), 0)
    obase = np.maximum(_lin(s, "obj_branch.base_layer.0", feats), 0)
    from hocon_torch.geometry.rot import rodrigues

    want_out = {
        "pose_pca": pose[:, :15], "root_rot": pose[:, 15:],
        "betas": _lin(s, "mano_branch.shape_reg", base),
        "trans": _lin(s, "absolute_branch.final_layer", abase),
        "obj_trans": _lin(s, "obj_branch.trans_reg", obase),
        "obj_rot": rodrigues(torch.from_numpy(_lin(s, "obj_branch.rot_reg", obase))).numpy(),
    }
    for key, value in want_out.items():
        np.testing.assert_allclose(out[key].numpy(), value, atol=2e-4, err_msg=key)


def test_z_init_fold_uses_the_models_value(mano_model, port_mano):
    """With ``z_init=0.35`` the folded biases are the model's: bit for bit
    the reference's, and the translation is the raw regression."""
    sd = reference_state_dict(1)
    ref, variables, port, (x, k, obj) = _models(mano_model, z_init=0.35)
    want = flax_to_state_dict(ref_import.import_hocnet(variables, _np(sd), model=ref))
    torch_import.import_hocnet(port, sd)
    assert_bit_equal(_state_dict_np(port), want)
    s = _np(sd)
    np.testing.assert_array_equal(
        port.absolute_head.trans_mlp.layers[1].bias.detach().numpy(),
        s["absolute_branch.final_layer.bias"] + np.float32([0.0, 0.0, -0.35]))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(k), port_mano, torch.from_numpy(obj))
        feats = tv_resnet(1)(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    abase = np.maximum(_lin(s, "absolute_branch.base_layer.0", feats), 0)
    np.testing.assert_allclose(out["trans"].numpy(),
                               _lin(s, "absolute_branch.final_layer", abase), atol=2e-4)


def test_hand_only_checkpoint_with_loose_heads(mano_model):
    """A checkpoint without the object branch: ``strict_heads=False`` skips
    the object heads (they keep their weights), as the reference does;
    ``strict_heads=True`` raises ``KeyError`` and leaves the model as it
    was."""
    sd = reference_state_dict(2, with_obj=False)
    ref, variables, port, _ = _models(mano_model)
    before = _state_dict_np(port)
    with pytest.raises(KeyError, match="obj_branch"):
        torch_import.import_hocnet(port, sd)
    assert_bit_equal(_state_dict_np(port), before)
    want = flax_to_state_dict(
        ref_import.import_hocnet(variables, _np(sd), model=ref, strict_heads=False))
    torch_import.import_hocnet(port, sd, strict_heads=False)
    got = _state_dict_np(port)
    assert_bit_equal(got, want)
    key = "obj_head.objrot_mlp.layers.1.weight"
    assert got[key].tobytes() == before[key].tobytes()
    assert got["trunk.conv_init.weight"].tobytes() != before["trunk.conv_init.weight"].tobytes()


def test_hand_only_model_skips_object_heads(mano_model):
    """A model without the object head imports a full checkpoint's hand."""
    sd = reference_state_dict(3)
    ref, variables, port, _ = _models(mano_model, with_object=False)
    want = flax_to_state_dict(ref_import.import_hocnet(variables, _np(sd), model=ref))
    torch_import.import_hocnet(port, sd)
    assert_bit_equal(_state_dict_np(port), want)


def test_missing_key_and_shape_mismatch_raise(mano_model):
    """A missing trunk key raises ``KeyError``; the reference's axis-angle
    rotation into the default 6d head raises ``ValueError``, as in
    ``hocon``; neither changes the model."""
    trunk = resnet18()
    before = _state_dict_np(trunk)
    with pytest.raises(KeyError, match="conv1.weight"):
        torch_import.import_resnet_trunk({}, trunk)
    sd = tv_resnet(0).state_dict()
    del sd["layer3.1.bn2.running_var"]
    with pytest.raises(KeyError, match="layer3.1.bn2.running_var"):
        torch_import.import_resnet_trunk(sd, trunk)
    assert_bit_equal(_state_dict_np(trunk), before)

    full = reference_state_dict(0)
    ref, variables, port, _ = _models(mano_model, obj_rot_param="6d")
    with pytest.raises(ValueError, match="shape mismatch"):
        ref_import.import_hocnet(variables, _np(full), model=ref)
    before = _state_dict_np(port)
    with pytest.raises(ValueError, match="shape mismatch at obj_head.objrot_mlp.layers.1"):
        torch_import.import_hocnet(port, full)
    assert_bit_equal(_state_dict_np(port), before)


def test_load_torch_checkpoint(tmp_path):
    """The ``state_dict`` entry, ``module.`` removed, non-tensors dropped:
    the reference's keys and values."""
    sd = {"module.conv1.weight": torch.ones(2, 3), "module.layer1.0.bn1.bias": torch.arange(3.0)}
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "a.pth")
    torch.save({"conv1.weight": torch.zeros(1), "note": "x"}, tmp_path / "b.pth")
    for name in ("a.pth", "b.pth"):
        got = torch_import.load_torch_checkpoint(str(tmp_path / name))
        want = ref_import.load_torch_checkpoint(str(tmp_path / name))
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), want[key])


# --- the CLIs -----------------------------------------------------------------------

class _Args:
    def __init__(self, **kw):
        self.__dict__.update(torch_trunk="", torch_ckpt="", backbone="resnet18",
                             torch_trunk_prefix="base_net.", torch_loose=False)
        self.__dict__.update(kw)


@pytest.mark.parametrize("case", ["both", "backbone"])
def test_apply_torch_init_refuses(case):
    args = {"both": _Args(torch_trunk="a.pth", torch_ckpt="b.pth"),
            "backbone": _Args(torch_trunk="a.pth", backbone="resnet101")}[case]
    with pytest.raises(ValueError, match="exclusive" if case == "both" else "backbones"):
        apply_torch_init(args, None, None)
    assert apply_torch_init(_Args(), None, "state") == "state"


def _trunk_state_dict_of(model) -> dict:
    return {k[len("trunk."):]: v for k, v in _state_dict_np(model).items()
            if k.startswith("trunk.")}


def _tv_trunk_as_port(seed: int) -> dict:
    """A torchvision trunk's weights under the port's names."""
    trunk = resnet18()
    torch_import.import_resnet_trunk(tv_resnet(seed).state_dict(), trunk)
    return _state_dict_np(trunk)


def test_evaluate_with_a_reference_checkpoint(tmp_path, monkeypatch, capsys):
    """``evaluate --torch_ckpt`` scores a reference checkpoint end to end
    on the CPU, with the object rotation switched to axis-angle."""
    monkeypatch.chdir(tmp_path)
    torch.save({"state_dict": reference_state_dict(0), "epoch": 3}, tmp_path / "ref.pth")
    metrics = evaluate.main(SMALL + ["--use_objects", "--torch_ckpt", str(tmp_path / "ref.pth")],
                            device="cpu")
    out = capsys.readouterr().out
    assert "--torch_ckpt implies --obj_rot_param axisang" in out
    assert "imported reference checkpoint" in out
    assert np.isfinite(metrics["mpjpe_mm"]) and 0.0 <= metrics["auc"] <= 1.0


def test_train_with_a_torchvision_trunk_then_resume(tmp_path, monkeypatch, capsys):
    """``train --torch_trunk --lr 0`` trains with the file's trunk, which is
    unchanged after the steps; a later ``--resume`` of that run's snapshot
    overrides another file's import."""
    monkeypatch.chdir(tmp_path)
    torch.save(tv_resnet(6).state_dict(), tmp_path / "trunk6.pth")
    torch.save(tv_resnet(7).state_dict(), tmp_path / "trunk7.pth")
    state = train.main(SMALL + ["--torch_trunk", str(tmp_path / "trunk6.pth"), "--lr", "0",
                                "--exp_id", "t"], device="cpu")
    assert "imported ImageNet trunk weights" in capsys.readouterr().out
    assert state.step > 0
    assert_bit_equal(_trunk_state_dict_of(state.model), _tv_trunk_as_port(6))

    ckpt = str(tmp_path / "checkpoints" / "t" / "ckpt")
    state = train.main(SMALL + ["--torch_trunk", str(tmp_path / "trunk7.pth"), "--lr", "0",
                                "--resume", ckpt, "--exp_id", "r"], device="cpu")
    out = capsys.readouterr().out
    assert "imported ImageNet trunk weights" in out and "resumed from" in out
    assert_bit_equal(_trunk_state_dict_of(state.model), _tv_trunk_as_port(6))
    assert os.path.isdir(tmp_path / "checkpoints" / "r" / "ckpt")


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_adam_at_rate_zero_moves_nothing(name):
    """``--lr 0`` (a frozen import, as above): optax's Adam and AdamW leave
    every weight as it was, and so does the port's; its rate rescaling
    once divided by the rate."""
    import optax

    from hocon_torch.train.state import apply_gradients, create_train_state, make_optimizer

    model = nn.Linear(3, 2)
    w0 = _state_dict_np(model)
    state = create_train_state(model, make_optimizer(name, 0.0, weight_decay=1e-2))
    for _ in range(2):
        state.optimizer.zero_grad()
        model(torch.ones(4, 3)).square().sum().backward()
        apply_gradients(state)
    assert_bit_equal(_state_dict_np(model), w0)
    tx = optax.adamw(0.0, weight_decay=1e-2) if name == "adamw" else optax.adam(0.0)
    params = {k: jnp.asarray(v) for k, v in w0.items()}
    updates, _ = tx.update({k: jnp.ones_like(v) for k, v in params.items()}, tx.init(params),
                           params)
    for k, v in optax.apply_updates(params, updates).items():
        assert np.asarray(v).tobytes() == w0[k].tobytes(), k
