"""HaMeR in the port (``hocon_torch.models.hamer``, ``.vit``, ``.attention``)
against the benchmark's plain reference (``benchmark/reference/families/
hamer.py``) on the CPU, at a small size: a ViT of depth 2, width 64 and 4
heads with patch 16 on 64^2 crops (12 tokens), a decoder of depth 2. Both
load one set of seeded weights and run in float32; the inputs are the
benchmark's synthetic scene.

Also: MANO from rotation matrices against ``mano_forward``; the train
CLIs' ``--model hamer`` through ``build_model`` and one warp train step;
the attention calls a forward at HaMeR's published depths; the PyTorch
weight import refusing HaMeR.
"""

import argparse
import os
import statistics
import sys

import pytest
import torch

from hocon_torch.cli import train as train_cli
from hocon_torch.geometry import mano as TM
from hocon_torch.geometry import rot as TR
from hocon_torch.geometry.mano import ManoModel
from hocon_torch.models import attention as attn_mod
from hocon_torch.models.hamer import HaMeR, MANOTransformerDecoderHead
from hocon_torch.models.losses import total_supervised_loss
from hocon_torch.models.vit import ViT
from hocon_torch.train import steps
from hocon_torch.train.state import create_train_state, make_optimizer

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import scene  # noqa: E402
from reference import step as ref_step  # noqa: E402
from reference.families import hamer as ref_hamer  # noqa: E402

torch.set_num_threads(1)
SEED = 2**31 + 2024
SMALL = dict(patch=16, patch_padding=2, vit_dim=64, vit_depth=2, vit_heads=4, vit_mlp_dim=256,
             dec_dim=64, dec_depth=2, dec_heads=4, dec_dim_head=16, dec_mlp_dim=64,
             dec_context_dim=64, pose_out=96, betas_out=10, cam_out=3, cam_scale_init=10.0,
             center_idx=9, with_object=False, trunk_dtype="float32")
LAMBDAS = {"verts3d": 0.167, "joints3d": 0.167, "joints2d": 0.5, "shape": 1e-6, "pose": 1e-6,
           "obj_verts3d": 0.167}
CFG = {
    "model": SMALL,
    "data": {"image_size": 64, "pairs_per_step": 2, "videos": 2, "frames_per_video": 8,
             "annotated_every": 8, "pair_spacing": 3, "object": "none", "object_faces": 0,
             "object_size": 0.06},
    "training": {"lr": 1e-5, "lambda_consist": 1.0, "consist_gt_refs": True, "sigma": 1.0,
                 "gamma": 0.025, "backface_cull": True, "lambdas": LAMBDAS},
    "traffic": {"pool": 1},
}
# Port against reference, float32 on the CPU, each gap over the largest
# magnitude of the reference's tensor. The two differ only in attention
# (PyTorch's fused CPU kernel against the explicit softmax), so the model's
# outputs agree to float32 rounding carried through two blocks and two
# decoder layers.
OUT_RTOL = 2e-5
# The supervised loss and each leaf's gradient of it (the gap of the
# gradient over its norm): readings at most 1.6e-7 and 3.8e-7 over four
# seeds.
SUP_RTOL, SUP_GRAD_RTOL = 2e-5, 1e-5
# The warp loss. Its photometric terms: the soft raster's rim slivers
# amplify float32 rounding of the vertices about a thousandfold
# (``benchmark/harness/compare.py``; readings up to 7e-5 over four seeds);
# the total is mostly the supervised terms (readings up to 1.6e-7).
PHOTO_RTOL, WARP_RTOL = 1e-3, 1e-5
# Its gradients: the median leaf's gap (readings up to 4.1e-4 over four
# seeds) and every leaf's, whose worst is the shape read-out, whose gradient
# comes through MANO's shape blend shapes from those rims (readings 2.7e-3
# to 0.091).
WARP_GRAD_MEDIAN_RTOL, WARP_GRAD_RTOL = 2e-3, 0.25


def _port_model(**kw) -> HaMeR:
    m = SMALL
    return HaMeR(image_size=CFG["data"]["image_size"], patch=m["patch"], vit_dim=m["vit_dim"],
                 vit_depth=m["vit_depth"], vit_heads=m["vit_heads"],
                 vit_mlp_ratio=m["vit_mlp_dim"] // m["vit_dim"], dec_dim=m["dec_dim"],
                 dec_depth=m["dec_depth"], dec_heads=m["dec_heads"],
                 dec_dim_head=m["dec_dim_head"], dec_mlp_dim=m["dec_mlp_dim"],
                 cam_scale_init=m["cam_scale_init"], center_idx=m["center_idx"], **kw)


@pytest.fixture(scope="module")
def setup():
    """The scene's MANO arrays and one batch, the reference's seeded weights,
    the port's and the reference's models holding them."""
    dev = torch.device("cpu")
    mano = scene.mano_arrays(SEED, dev)
    batch = scene.batch_pool(CFG, mano, SEED, dev)[0]
    weights = ref_hamer.weights(CFG, scene.generator(SEED, 1, dev), dev)
    port = _port_model(dtype=torch.float32, seed=0, device="cpu")
    port.load_state_dict(weights, strict=True)
    ref = ref_hamer.Model(CFG)
    ref.load_state_dict(weights, strict=True)
    return mano, ManoModel(**mano), batch, port, ref


def _gap(a, b) -> float:
    """The largest difference over the largest magnitude of ``b``."""
    return float((a - b).abs().max() / b.abs().max())


def test_state_dicts_share_names_and_shapes(setup):
    _, _, _, port, ref = setup
    assert {k: v.shape for k, v in port.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}


def test_outputs_agree_with_the_reference(setup):
    mano, mano_model, batch, port, ref = setup
    view = batch["ref"]
    with torch.no_grad():
        got = port(view["image"], view["camintr"], mano_model)
        want = ref(view["image"], view["camintr"], mano)
    assert set(want) <= set(got)
    for k, v in want.items():
        assert _gap(got[k], v) <= OUT_RTOL, (k, _gap(got[k], v))
    assert got["root_rot"].shape == (2, 3, 3) and got["trans"].shape == (2, 3)


def _grad_gaps(port, ref) -> dict:
    """Each leaf's gradient gap over the reference gradient's norm."""
    want = dict(ref.named_parameters())
    out = {}
    for name, p in port.named_parameters():
        g, w = p.grad, want[name].grad
        assert g is not None and w is not None, name
        norm = float(torch.linalg.vector_norm(w))
        # The query embedding's weight multiplies a zero input: no gradient.
        out[name] = float(torch.linalg.vector_norm(g - w)) / (norm if norm > 0 else 1.0)
    return out


def _hand_lambdas() -> dict:
    return {f"lambda_{k}": v for k, v in LAMBDAS.items() if k != "obj_verts3d"}


def test_supervised_loss_and_every_gradient_agree_with_the_reference(setup):
    mano, mano_model, batch, port, ref = setup
    view = batch["ref"]
    port.zero_grad(set_to_none=True)
    ref.zero_grad(set_to_none=True)
    loss, _ = total_supervised_loss(port(view["image"], view["camintr"], mano_model),
                                    steps._gt_from_batch(view), view["sup_mask"],
                                    hand_lambdas=_hand_lambdas())
    want, _ = ref_step.supervised_loss(ref(view["image"], view["camintr"], mano), view, LAMBDAS)
    loss.backward()
    want.backward()
    assert _gap(loss.detach(), want.detach()) <= SUP_RTOL
    gaps = _grad_gaps(port, ref)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= SUP_GRAD_RTOL, (worst, gaps[worst])


def test_warp_loss_and_every_gradient_agree_with_the_reference(setup):
    mano, mano_model, batch, port, ref = setup
    tr = CFG["training"]
    port.zero_grad(set_to_none=True)
    ref.zero_grad(set_to_none=True)
    loss, terms = steps.warp_loss(
        port, mano_model, batch, (64, 64), hand_lambdas=_hand_lambdas(),
        lambda_consist=tr["lambda_consist"], consist_gt_refs=tr["consist_gt_refs"],
        sigma=tr["sigma"], gamma=tr["gamma"], backface_cull=tr["backface_cull"], device="cpu")
    want_loss, want_terms = ref_step.warp_loss(ref, mano, batch, CFG)
    loss.backward()
    want_loss.backward()
    for k in ("loss_hand_verts3d", "loss_hand_joints3d", "loss_hand_joints2d"):
        assert _gap(terms[f"ref_{k}"].detach(), want_terms[f"ref_{k}"].detach()) <= SUP_RTOL, k
    for k in ("photo_l1", "photo_dssim"):
        assert _gap(terms[k].detach(), want_terms[k].detach()) <= PHOTO_RTOL, k
    assert _gap(loss.detach(), want_loss.detach()) <= WARP_RTOL
    gaps = _grad_gaps(port, ref)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= WARP_GRAD_RTOL, (worst, gaps[worst])
    assert statistics.median(gaps.values()) <= WARP_GRAD_MEDIAN_RTOL


def test_single_key_attention_returns_the_values_and_no_query_gradient():
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 4, 1, 8, generator=gen, requires_grad=True) for _ in range(3))
    out = attn_mod.attention(q, k, v)
    assert torch.equal(out, v)
    out.square().sum().backward()
    assert q.grad is None and k.grad is None and torch.equal(v.grad, 2 * v.detach())


def _exact_attention(q, k, v):
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("d", [80, 64])
def test_reference_bf16_attention_is_attention_at_bf16_rounding(d):
    """The reference's bf16 attention (``FlashAttend``: probabilities and
    the backward's score gradient rounded to bf16 over flash attention's
    key blocks) against the exact attention of the same bf16 inputs in
    float64: forward and every gradient within a few bf16 roundings (2^-8
    is 3.9e-3; readings 1.8e-3 to 3.0e-3 at the trunk's shapes), over 200
    keys, so that the running maximum crosses blocks."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = ((torch.randn(2, 3, n, d, generator=gen) * (2.0 if i < 2 else 1.0)).bfloat16()
               for i, n in enumerate((40, 200, 200)))
    g = torch.randn(2, 3, 40, d, generator=gen).bfloat16()
    got, want = [], []
    for fn, dtype, out in ((ref_hamer.attend, torch.bfloat16, got),
                           (_exact_attention, torch.float64, want)):
        leaves = [t.detach().to(dtype).clone().requires_grad_() for t in (q, k, v)]
        y = fn(*leaves)
        y.backward(g.to(dtype))
        out += [y.detach()] + [t.grad for t in leaves]
    assert got[0].dtype == torch.bfloat16
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        gap = float((a.double() - b).norm() / b.norm())
        assert gap < 6e-3, (name, gap)


def test_rotmat_mano_is_mano_forward_on_rodrigues():
    """``mano_forward`` is Rodrigues then ``mano_forward_rotmat``: the same
    bits from the matrices of the same axis-angles."""
    mano = TM.synthetic_mano_model(0, device="cpu")
    gen = torch.Generator().manual_seed(7)
    pose, betas, rot = (torch.randn(3, 15, generator=gen), torch.randn(3, 10, generator=gen),
                        torch.randn(3, 3, generator=gen) * 0.5)
    full = TM.pca_to_full_pose(mano, pose)
    rots = TR.rodrigues(torch.cat([rot, full], dim=-1).reshape(3, 16, 3))
    for kw in ({"scale_mm": False}, {}, {"center_idx": 9}):
        want = TM.mano_forward(mano, pose, betas, rot, **kw)
        got = TM.mano_forward_rotmat(mano, rots, betas, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), kw


def _args(argv):
    p = argparse.ArgumentParser()
    from hocon_torch.cli import opts

    opts.add_exp_opts(p)
    opts.add_net_opts(p)
    opts.add_data_opts(p)
    return p.parse_args(argv)


def test_build_model_makes_hamer_and_a_warp_step_runs(monkeypatch):
    """``--model hamer`` through ``build_model`` (HaMeR's widths cut to the
    small size here), then one ``make_warp_train_step`` step: finite terms,
    every parameter moved by Adam but the query embedding's weight, which
    multiplies a zero input."""
    m = SMALL
    small = dict(patch=m["patch"], vit_dim=m["vit_dim"], vit_depth=m["vit_depth"],
                 vit_heads=m["vit_heads"], dec_dim=m["dec_dim"], dec_depth=m["dec_depth"],
                 dec_heads=m["dec_heads"], dec_dim_head=m["dec_dim_head"],
                 dec_mlp_dim=m["dec_mlp_dim"])
    monkeypatch.setattr(train_cli, "HaMeR", lambda **kw: HaMeR(**small, **kw))
    args = _args(["--model", "hamer", "--image_size", "64", "--no_bf16"])
    mano = TM.synthetic_mano_model(0, device="cpu")
    model = train_cli.build_model(args, mano, torch.device("cpu"), seed=3)
    assert isinstance(model, HaMeR) and model.dtype == torch.float32
    spec = make_optimizer("adam", 1e-4)
    state = create_train_state(model, spec)
    step = steps.make_warp_train_step(model, mano, spec, image_size=(64, 64), device="cpu")
    dev = torch.device("cpu")
    arrays = {k: getattr(mano, k) for k in ("v_template", "shapedirs", "posedirs",
                                             "joint_regressor", "skin_weights",
                                             "hands_components", "hands_mean", "faces")}
    batch = scene.batch_pool(CFG, arrays, SEED, dev)[0]
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state, terms = step(state, batch)
    assert all(torch.isfinite(v).all() for v in terms.values())
    moved = [k for k, p in model.named_parameters() if not torch.equal(p, before[k])]
    assert set(before) - set(moved) == {"mano_head.transformer.to_token_embedding.weight"}


def test_build_model_refuses_hamer_with_objects():
    args = _args(["--model", "hamer", "--use_objects"])
    with pytest.raises(ValueError, match="no object head"):
        train_cli.build_model(args, None, torch.device("cpu"))


def test_attention_calls_a_forward():
    """44 a forward at HaMeR's depths (32 trunk blocks, 6 decoder layers of
    self- and cross-attention), counted on the meta device; 2 + 4 at the
    small size on the CPU."""
    with torch.device("meta"):
        vit = ViT()
        head = MANOTransformerDecoderHead(1024, 6, 8, 64, 1024, 1280, 10.0)
        images = torch.empty(2, 3, 256, 192)
    before = attn_mod.attention.calls
    tokens = vit(images)
    assert tokens.shape == (2, 192, 1280)
    assert head.transformer(tokens).shape == (2, 1024)
    assert attn_mod.attention.calls - before == 44

    model = _port_model(dtype=torch.float32, seed=0, device="cpu")
    before = attn_mod.attention.calls
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3), torch.eye(3)[None] * 100.0,
              TM.synthetic_mano_model(0, device="cpu"))
    assert attn_mod.attention.calls - before == 2 + 4


@pytest.mark.parametrize("flag", ["--torch_trunk", "--torch_ckpt"])
def test_torch_weight_import_refuses_hamer(flag):
    args = _args(["--model", "hamer", flag, "weights.pth"])
    with pytest.raises(ValueError, match="--model hamer has no ResNet trunk"):
        train_cli.apply_torch_init(args, None, None)
