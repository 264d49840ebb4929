"""HOCNet's trunk and heads through ``graphed_model``, and the one graph
cache of each model (``hocon_torch.models.graphs``), on the CPU: what a
capture fixes, what the CPU path keeps, and the pieces of the replay that
need no card.

On the CPU HOCNet runs its regressions eagerly, with the outputs and
gradients of the trunk, the heads and ``mano_forward`` called directly.
The key of HOCNet's regressions separates a moved or replaced parameter,
the training mode, the object head, autocast and the precision switches;
both MANO bodies go through ``graphed_mano`` under one counter pair, keyed
by the body's name. The heads' constants are made once per device and
dtype, with ``new_tensor``'s bits. A deep copy of HOCNet or HaMeR starts
with an empty cache, and the state dict is unchanged. Each call's outputs
are copies laid out as the captured ones. Each parameter's gradient is
laid out as ``AccumulateGrad`` lays it out. The capture's parameter
stand-ins share the parameters' storage and are put back. The graphs
themselves need the card: ``chip_smoke.py``'s ``model_graph`` phase holds
them to eager mode bit for bit.
"""

import copy
import threading
from unittest import mock

import pytest
import torch
from torch import nn

from hocon_torch.geometry import mano as TM
from hocon_torch.geometry.project import persp_project, transform_points
from hocon_torch.models import graphs as MG
from hocon_torch.models import heads as TH
from hocon_torch.models.hamer import HaMeR
from hocon_torch.models.hocnet import HOCNet

torch.set_num_threads(1)


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().flatten().contiguous().view(torch.uint8),
        b.detach().flatten().contiguous().view(torch.uint8))


def _inputs(n=2, res=32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn(n, res, res, 3, generator=gen)
    camintr = torch.tensor([[[40.0, 0.0, res / 2], [0.0, 40.0, res / 2], [0.0, 0.0, 1.0]]] * n)
    obj = torch.randn(n, 12, 3, generator=gen) * 0.05
    return images, camintr, obj


@pytest.fixture(scope="module")
def mano():
    return TM.synthetic_mano_model(0, device="cpu")


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that an entry of
    ``graphs`` goes on to its key."""

    is_cuda = True


class _Keyed(Exception):
    """Raised in place of a capture, with the entry's arguments."""


def _keyed(graphs, key, grad, fn, inputs, counter, module=None, params=()):
    raise _Keyed(key, grad, fn, inputs, counter)


def _entry(call):
    """(key, grad, fn, inputs, counter) that ``call``'s first entry hands
    ``_graphed``."""
    with mock.patch.object(MG, "_graphed", _keyed), pytest.raises(_Keyed) as got:
        call()
    return got.value.args


def _key(model, images, with_obj=True):
    """The key ``HOCNet.forward`` gives its regressions' graph."""
    _, camintr, obj = _inputs()
    return _entry(lambda: model(images.as_subclass(_OnCard), camintr, None,
                                obj if with_obj else None))[0]


@pytest.mark.parametrize("change", ["replaced", "moved", "requires_grad", "eval", "no_object",
                                    "autocast", "no_grad", "batch", "layout", "deterministic",
                                    "cudnn_tf32", "matmul_tf32", "none"])
def test_signature_separates_what_a_capture_fixes(change, monkeypatch):
    model = HOCNet(with_object=True, seed=0, device="cpu")
    images = _inputs()[0]
    base = _key(model, images)
    assert base[:2] == ("HOCNet._regress", True)
    with_obj = True
    if change == "deterministic":
        monkeypatch.setattr(torch.backends.cudnn, "deterministic",
                            not torch.backends.cudnn.deterministic)
    elif change == "cudnn_tf32":
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", not torch.backends.cudnn.allow_tf32)
    elif change == "matmul_tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not torch.backends.cuda.matmul.allow_tf32)
    elif change == "replaced":
        w = model.absolute_head.trans_mlp.layers[0].weight
        model.absolute_head.trans_mlp.layers[0].weight = nn.Parameter(w.detach().clone())
    elif change == "moved":
        model.double()
        images = images.double()
    elif change == "requires_grad":
        model.trunk.conv_init.weight.requires_grad_(False)
    elif change == "eval":
        model.eval()
    elif change == "no_object":
        with_obj = False
    elif change == "batch":
        images = _inputs(n=3)[0]
    elif change == "layout":
        images = images.permute(0, 2, 1, 3)
    if change == "autocast":
        with torch.autocast("cpu", dtype=torch.bfloat16):
            key = _key(model, images, with_obj)
    elif change == "no_grad":
        with torch.no_grad():
            key = _key(model, images, with_obj)
    else:
        key = _key(model, images, with_obj)
    assert (key == base) == (change == "none")
    assert hash(key) is not None


@pytest.mark.parametrize("with_object", [True, False])
def test_hocnet_on_the_cpu_runs_its_regressions_eagerly(mano, with_object):
    """No capture; HOCNet's outputs and every parameter's gradient are those
    of the trunk, the heads and ``mano_forward`` called directly, bit for
    bit."""
    counts = (MG.graphed_model.captures, MG.graphed_model.replays)
    model = HOCNet(with_object=with_object, seed=0, device="cpu")
    images, camintr, obj = _inputs(seed=1)
    obj = obj if with_object else None

    def loss_of(out):
        loss = out["verts_cam"].square().sum() + out["joints2d"].sum()
        if with_object:
            loss = loss + out["obj_verts2d"].sum()
        return loss

    out = model(images, camintr, mano, obj)
    got = torch.autograd.grad(loss_of(out), list(model.parameters()), allow_unused=True)
    assert (MG.graphed_model.captures, MG.graphed_model.replays) == counts == (0, 0)
    assert len(model.graphs) == 0

    feats = model.trunk(images)
    pose_pca, betas, root_rot = model.mano_head(feats)
    trans = model.absolute_head(feats)
    verts, joints = TM.mano_forward(mano, pose_pca, betas, root_rot, scale_mm=False)
    verts_cam, joints_cam = verts + trans[:, None], joints + trans[:, None]
    center = joints_cam[:, model.center_idx : model.center_idx + 1]
    want = {"pose_pca": pose_pca, "betas": betas, "root_rot": root_rot, "trans": trans,
            "verts_cam": verts_cam, "joints_cam": joints_cam,
            "verts_c_mm": (verts_cam - center) * 1000.0,
            "joints_c_mm": (joints_cam - center) * 1000.0,
            "joints2d": persp_project(joints_cam, camintr),
            "verts2d": persp_project(verts_cam, camintr), "center_cam": center}
    if with_object:
        obj_rot, obj_trans = model.obj_head(feats)
        obj_cam = transform_points(obj, obj_rot, obj_trans)
        want.update(obj_rot=obj_rot, obj_trans=obj_trans, obj_verts_cam=obj_cam,
                    obj_verts_c_mm=(obj_cam - center) * 1000.0,
                    obj_verts2d=persp_project(obj_cam, camintr))
    assert out.keys() == want.keys()
    for k in want:
        assert _same_bits(out[k], want[k]), k
        assert out[k].stride() == want[k].stride(), k
    wanted = torch.autograd.grad(loss_of(want), list(model.parameters()), allow_unused=True)
    for (name, _), g, w in zip(model.named_parameters(), got, wanted):
        assert (g is None) == (w is None), name
        assert g is None or _same_bits(g, w), name


def _small_hamer() -> HaMeR:
    """HaMeR at the small widths of ``tests/test_torch_hamer.py``."""
    return HaMeR(image_size=64, patch=16, vit_dim=64, vit_depth=2, vit_heads=4, vit_mlp_ratio=4,
                 dec_dim=64, dec_depth=2, dec_heads=4, dec_dim_head=16, dec_mlp_dim=64,
                 dtype=torch.float32, seed=0, device="cpu")


@pytest.mark.parametrize("kind", ["hocnet", "hamer"])
def test_cache_stays_out_of_state_dict_and_copies(mano, kind):
    """One ``graphs`` cache a model: not in the state dict, empty in a deep
    copy, left empty by a forward on the CPU."""
    model = HOCNet(with_object=True, seed=0, device="cpu") if kind == "hocnet" else _small_hamer()
    names = {n for n, _ in model.named_parameters()} | {n for n, _ in model.named_buffers()}
    assert set(model.state_dict()) == names
    assert not any("graph" in n for n in names)
    assert not any("mano" in n and "head" not in n for n in names)
    assert [n for n, v in vars(model).items() if isinstance(v, MG.Graphs)] == ["graphs"]
    # A captured graph cannot be copied: stand one in.
    model.graphs["key"] = threading.Lock()
    twin = copy.deepcopy(model)
    assert len(twin.graphs) == 0 and len(model.graphs) == 1
    assert twin.graphs is not model.graphs
    assert set(twin.state_dict()) == names
    images, camintr, obj = _inputs(res=64 if kind == "hamer" else 32, seed=7)
    with torch.no_grad():
        twin(images, camintr, mano, obj)
    assert len(twin.graphs) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_head_constants_made_once_with_new_tensors_bits(dtype):
    """Each constant is one tensor per (values, device, dtype), and every
    head's output keeps the bits of the sum with ``new_tensor``."""
    gen = torch.Generator().manual_seed(5)
    feats = torch.randn(4, 16, generator=gen, dtype=dtype)
    absolute = TH.AbsoluteHead(16, z_init=0.7).to(dtype)
    six = TH.ObjPoseHead(16, rot_param="6d", z_init=0.7).to(dtype)
    axis = TH.ObjPoseHead(16, rot_param="axisang", z_init=0.7).to(dtype)
    for m in (absolute, six, axis):
        for p in m.parameters():
            nn.init.normal_(p, std=0.3, generator=gen)
    cpu = torch.device("cpu")
    z = TH._constant((0.0, 0.0, 0.7), cpu, dtype)
    assert TH._constant((0.0, 0.0, 0.7), cpu, dtype) is z and z.dtype == dtype
    assert TH._constant((0.0, 0.0, 0.7), cpu, torch.float16) is not z

    out = absolute.trans_mlp(feats)
    assert _same_bits(absolute(feats), out + out.new_tensor([0.0, 0.0, 0.7]))
    rot, trans = six(feats)
    out = six.objtrans_mlp(feats)
    assert _same_bits(trans, out + out.new_tensor([0.0, 0.0, 0.7]))
    raw = six.objrot_mlp(feats)
    want = TH.rot6d_to_matrix(raw + raw.new_tensor([1.0, 0, 0, 0, 1.0, 0]))
    assert _same_bits(rot, want) and rot.stride() == want.stride()
    rot, _ = axis(feats)
    assert _same_bits(rot, TH.rodrigues(axis.objrot_mlp(feats)))


@pytest.mark.parametrize("body", [TM.mano_forward, TM.mano_forward_rotmat])
def test_both_mano_bodies_go_through_one_entry(mano, body):
    """``graphed_mano`` keys a body's graph by its name and ``graph_signature``
    over the MANO model and the inputs, counts it under its own counter pair
    apart from the model's, and captures ``body(mano, *inputs,
    scale_mm=False)``."""
    gen = torch.Generator().manual_seed(8)
    betas = torch.randn(3, 10, generator=gen, requires_grad=True)
    if body is TM.mano_forward:
        head = torch.randn(3, 18, generator=gen, requires_grad=True)
        inputs = (head[:, :15], betas, head[:, 15:])
    else:
        six = torch.randn(3, 16, 6, generator=gen, requires_grad=True)
        inputs = (TH.rot6d_to_matrix(six), betas)
    on_card = (inputs[0].as_subclass(_OnCard), *inputs[1:])
    key, grad, fn, captured, counter = _entry(lambda: MG.graphed_mano(MG.Graphs(), body, mano,
                                                                      *on_card))
    want = (torch.device("cpu"), True, False, torch.is_autocast_enabled("cpu"),
            torch.get_autocast_dtype("cpu"), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, id(mano),
            tuple((x.shape, x.stride(), x.storage_offset(), x.dtype, True) for x in inputs))
    assert key == (body.__name__,) + want and grad
    assert MG.graph_signature(mano, inputs) == want
    assert counter is MG.graphed_mano and MG.graphed_mano is not MG.graphed_model
    for entry in (MG.graphed_mano, MG.graphed_model):
        assert isinstance(entry.captures, int) and isinstance(entry.replays, int)
    assert len(captured) == len(on_card) and all(a is b for a, b in zip(captured, on_card))
    got, wanted = fn(*inputs), body(mano, *inputs, scale_mm=False)
    assert all(_same_bits(a, b) for a, b in zip(got, wanted))


@pytest.mark.parametrize("case", ["pose_slices", "transposed", "expanded", "contiguous"])
def test_fresh_outputs_keep_the_layout_and_the_sharing(case):
    gen = torch.Generator().manual_seed(6)
    base = torch.randn(4, 18, generator=gen)
    outs = {
        "pose_slices": (base[:, :15], base[:, 15:]),
        "transposed": (torch.randn(4, 3, 3, generator=gen).transpose(-1, -2),),
        "expanded": (torch.eye(3).expand(4, 3, 3),),
        "contiguous": (base, torch.randn(4, 10, generator=gen)),
    }[case]
    fresh = MG._fresh(outs)
    for o, f in zip(outs, fresh):
        assert (f.shape, f.stride(), f.storage_offset()) == (o.shape, o.stride(),
                                                             o.storage_offset())
        assert torch.equal(f, o)
        assert f.untyped_storage().data_ptr() != o.untyped_storage().data_ptr()
    ptrs = {f.untyped_storage().data_ptr() for f in fresh}
    assert len(ptrs) == len({o.untyped_storage().data_ptr() for o in outs})
    if case == "contiguous":
        assert all(not f._is_view() for f in fresh)  # as ``clone`` gives them


def test_parameter_gradients_are_laid_out_as_accumulate_grad_lays_them():
    p = nn.Parameter(torch.randn(8, 3, 3, 3))
    g = torch.randn(8, 3, 3, 3).contiguous(memory_format=torch.channels_last)
    got = MG._as_accumulated(g, p)
    assert got.stride() == p.stride() and torch.equal(got, g)
    # What eager mode's ``AccumulateGrad`` keeps for the same gradient.
    (p * g).sum().backward()
    assert p.grad.stride() == got.stride() and _same_bits(p.grad, got)
    same = torch.randn(8, 3, 3, 3)
    assert MG._as_accumulated(same, p) is same
    assert MG._as_accumulated(None, p) is None


def test_stand_ins_share_storage_and_are_put_back():
    model = HOCNet(with_object=False, seed=0, device="cpu")
    params = tuple(model.parameters())
    stand_ins = tuple(nn.Parameter(p.detach(), requires_grad=p.requires_grad) for p in params)
    with pytest.raises(KeyError):
        with MG._standing_in(model, params, stand_ins):
            inside = tuple(model.parameters())
            raise KeyError("raised inside")
    assert all(a is b for a, b in zip(inside, stand_ins)) and len(inside) == len(params)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(inside, params))
    assert all(a is b for a, b in zip(model.parameters(), params))
    with MG._standing_in(None, (), ()):
        pass


def test_trainable_norms_over_a_mesh_run_eagerly():
    """Only trainable batch norm with a mesh reduces over the ranks, which a
    capture cannot hold."""
    frozen = HOCNet(with_object=False, seed=0, device="cpu")
    trainable = HOCNet(with_object=False, freeze_batchnorm=False, seed=0, device="cpu")
    assert not frozen._collective_norms() and not trainable._collective_norms()
    for model in (frozen, trainable):
        model.trunk.bn_init.mesh = object()
    assert not frozen._collective_norms() and trainable._collective_norms()
