"""MANO's CUDA graphs in HOCNet and HaMeR (``hocon_torch.models.graphs``,
``graphed_mano``), on the CPU: what the graphs need of ``mano_forward`` and
what the CPU path keeps.

The fingertip and reorder gathers with device-resident indices, and
``with_zeros_4x4``'s bottom row made on the device, give the list index's
and the host tensor's bits. HOCNet on the CPU runs ``mano_forward`` itself,
and ``graphed_mano`` runs ``mano_forward_rotmat`` itself: no capture, the
same outputs and input gradients. The signature separates what a capture
fixes, and the input buffers keep the caller's layout. The graphs
themselves need the card: ``chip_smoke.py``'s ``mano_graph`` phase holds
them to ``mano_forward`` bit for bit.
"""

import pytest
import torch

from hocon_torch.geometry import mano as TM
from hocon_torch.geometry import rot as TR
from hocon_torch.models import graphs as MG
from hocon_torch.models.hocnet import HOCNet

torch.set_num_threads(1)


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().flatten().contiguous().view(torch.uint8),
        b.detach().flatten().contiguous().view(torch.uint8))


def _head_inputs(n, seed=0, ncomps=15):
    """(pose_pca, betas, root_rot) laid out as the pose head's: strided
    slices of one (n, ncomps + 3) output, and the tensors that hold grads."""
    gen = torch.Generator().manual_seed(seed)
    head = (torch.randn(n, ncomps + 3, generator=gen) * 0.5).requires_grad_()
    betas = torch.randn(n, 10, generator=gen).requires_grad_()
    return (head[:, :ncomps], betas, head[:, ncomps:]), (head, betas)


@pytest.fixture(scope="module")
def right():
    return TM.synthetic_mano_model(0, device="cpu")


@pytest.fixture(scope="module")
def left(right):
    return TM.mirror_mano_model(right)


@pytest.mark.parametrize("side", ["right", "mirror"])
def test_index_constants_give_the_list_index(right, left, side, monkeypatch):
    """Verts, joints and the inputs' gradients bit for bit the list index's."""
    mano = right if side == "right" else left
    inputs, leaves = _head_inputs(3, seed=1)
    gv, gj = torch.randn(3, 778, 3), torch.randn(3, 21, 3)

    def run():
        for t in leaves:
            t.grad = None
        verts, joints = TM.mano_forward(mano, *inputs, scale_mm=False)
        torch.autograd.backward((verts, joints), (gv, gj))
        return verts, joints, *(t.grad for t in leaves)

    got = run()
    tips, reorder = TM.mano_indices(torch.device("cpu"))
    assert TM.mano_indices(torch.device("cpu"))[0] is tips  # made once per device
    assert tips.dtype == reorder.dtype == torch.int64
    assert tips.tolist() == list(TM.FINGERTIP_VERT_IDS)
    assert reorder.tolist() == list(TM.JOINT_REORDER)
    monkeypatch.setattr(TM, "mano_indices",
                        lambda device: (list(TM.FINGERTIP_VERT_IDS), list(TM.JOINT_REORDER)))
    want = run()
    assert all(_same_bits(a, b) for a, b in zip(got, want))


def test_with_zeros_4x4_bottom_row_is_the_host_tensors():
    gen = torch.Generator().manual_seed(2)
    rot, trans = torch.randn(2, 16, 3, 3, generator=gen), torch.randn(2, 16, 3, generator=gen)
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(top.shape[:-2] + (1, 4))
    assert _same_bits(TR.with_zeros_4x4(rot, trans), torch.cat([top, bottom], dim=-2))


def test_hocnet_on_the_cpu_runs_mano_forward(right):
    """No capture; HOCNet's hand and the gradients at MANO's inputs are
    ``mano_forward``'s bit for bit on the same strided inputs."""
    captures, replays = MG.graphed_mano.captures, MG.graphed_mano.replays
    model = HOCNet(with_object=False, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    images = torch.randn(2, 32, 32, 3, generator=gen)
    camintr = torch.tensor([[[40.0, 0.0, 16.0], [0.0, 40.0, 16.0], [0.0, 0.0, 1.0]]] * 2)
    out = model(images, camintr, right)
    ins = (out["pose_pca"], out["betas"], out["root_rot"])
    loss = out["verts_cam"].square().sum() + out["joints_cam"].sum()
    got = torch.autograd.grad(loss, ins)
    assert MG.graphed_mano.captures == captures == 0
    assert MG.graphed_mano.replays == replays == 0
    assert len(model.graphs) == 0

    head = torch.cat([ins[0], ins[2]], dim=-1).detach().requires_grad_()
    betas = ins[1].detach().requires_grad_()
    pose, rot = head[:, :15], head[:, 15:]
    assert (pose.stride(), rot.stride()) == (ins[0].stride(), ins[2].stride())
    verts, joints = TM.mano_forward(right, pose, betas, rot, scale_mm=False)
    trans = out["trans"].detach()[:, None]
    assert _same_bits(out["verts_cam"], verts + trans)
    assert _same_bits(out["joints_cam"], joints + trans)
    (verts + trans).square().sum().add((joints + trans).sum()).backward()
    assert _same_bits(got[0], head.grad[:, :15]) and _same_bits(got[2], head.grad[:, 15:])
    assert _same_bits(got[1], betas.grad)


@pytest.mark.parametrize("change", ["batch", "dtype", "grad", "model", "layout", "deterministic",
                                    "cudnn_tf32", "matmul_tf32", "none"])
def test_signature_separates_what_a_capture_fixes(right, left, change, monkeypatch):
    inputs, _ = _head_inputs(4)
    base = MG.graph_signature(right, inputs)
    mano = right
    if change == "deterministic":
        monkeypatch.setattr(torch.backends.cudnn, "deterministic",
                            not torch.backends.cudnn.deterministic)
    elif change == "cudnn_tf32":
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", not torch.backends.cudnn.allow_tf32)
    elif change == "matmul_tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not torch.backends.cuda.matmul.allow_tf32)
    elif change == "batch":
        inputs, _ = _head_inputs(5)
    elif change == "dtype":
        inputs = tuple(x.double() for x in inputs)
    elif change == "model":
        mano = left
    elif change == "layout":
        inputs = tuple(x.detach().clone().requires_grad_() for x in inputs)
    if change == "grad":
        with torch.no_grad():
            key = MG.graph_signature(mano, inputs)
    else:
        key = MG.graph_signature(mano, inputs)
    assert (key == base) == (change == "none")
    assert hash(key) is not None


@pytest.mark.parametrize("view", ["contiguous", "slice", "transposed"])
def test_input_buffers_keep_the_callers_layout(view):
    x = torch.randn(6, 18)
    x = {"contiguous": x, "slice": x[:, 15:], "transposed": x.t()[3:]}[view]
    m = MG._mirror(x, requires_grad=True)
    assert (m.shape, m.stride(), m.storage_offset(), m.dtype) == (
        x.shape, x.stride(), x.storage_offset(), x.dtype)
    assert m.requires_grad and m.is_leaf and m.data_ptr() != x.data_ptr()
    with torch.no_grad():
        m.copy_(x)
    assert _same_bits(m, x)


def test_rotmat_signature_runs_eagerly_on_the_cpu(right):
    """HaMeR's body (``mano_forward_rotmat``, MANO from rotation matrices)
    through ``graphed_mano`` on the CPU: the body itself, bit for bit with
    its input gradients, no capture, the counters at 0 and the cache
    empty."""
    captures, replays = MG.graphed_mano.captures, MG.graphed_mano.replays
    gen = torch.Generator().manual_seed(4)
    six = torch.randn(3, 16, 6, generator=gen).requires_grad_()
    betas = torch.randn(3, 10, generator=gen).requires_grad_()
    rots = TR.rot6d_to_matrix(six)  # a transposed view, as HaMeR's
    graphs = MG.Graphs()
    gv = torch.randn(3, 778, 3, generator=gen)

    def run(fn):
        six.grad = betas.grad = None
        verts, joints = fn()
        (verts * gv).sum().add(joints.sum()).backward(retain_graph=True)
        return verts, joints, six.grad, betas.grad

    got = run(lambda: MG.graphed_mano(graphs, TM.mano_forward_rotmat, right, rots, betas))
    want = run(lambda: TM.mano_forward_rotmat(right, rots, betas, scale_mm=False))
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert MG.graphed_mano.captures == captures == 0
    assert MG.graphed_mano.replays == replays == 0
    assert len(graphs) == 0
