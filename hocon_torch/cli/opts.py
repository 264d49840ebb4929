"""Argparse flag groups.

Port of ``hocon/cli/opts.py``: the same four groups (experiment, net,
data, warp) with the same flags and defaults, so a command line means the
same to both packages.
"""

from __future__ import annotations

import argparse
import os


def add_exp_opts(p: argparse.ArgumentParser):
    g = p.add_argument_group("experiment")
    g.add_argument("--exp_id", default="run", help="run dir under checkpoints/")
    g.add_argument("--epochs", type=int, default=100)
    g.add_argument("--batch_size", type=int, default=16)
    g.add_argument("--optimizer", default="adam", choices=["adam", "adamw", "sgd"])
    g.add_argument("--lr", type=float, default=5e-5)
    g.add_argument("--momentum", type=float, default=0.9)
    g.add_argument("--weight_decay", type=float, default=0.0)
    g.add_argument("--lr_decay_step", type=int, default=0,
                   help="steps between LR decays (0 = constant)")
    g.add_argument("--lr_decay_gamma", type=float, default=0.5)
    g.add_argument("--grad_clip", type=float, default=0.0)
    g.add_argument("--snapshot_freq", type=int, default=1,
                   help="epochs between checkpoints")
    g.add_argument("--eval_freq", type=int, default=1)
    g.add_argument("--resume", default="", help="checkpoint dir to resume from")
    g.add_argument("--warm_start", default="",
                   help="checkpoint dir to load params (not opt state) from")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--max_steps_per_epoch", type=int, default=0)
    g.add_argument("--workers", type=int, default=0,
                   help="worker processes for train and eval data loading "
                        "(0 = in-process)")
    g.add_argument("--prefetch", type=int, default=2,
                   help="batches assembled ahead by a background thread "
                        "when --workers 0 (overlaps host data prep with "
                        "the device step; 0 = synchronous)")
    g.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of epoch 0 to <run_dir>/trace")
    g.add_argument("--vis_freq", type=int, default=0,
                   help="save qualitative grids every N eval batches "
                        "(trainwarp: warp panels every N epochs; 0=off)")


def add_net_opts(p: argparse.ArgumentParser):
    g = p.add_argument_group("net")
    g.add_argument("--model", default="hocnet", choices=["hocnet", "hamer"],
                   help="hocnet: ResNet trunk and MLP heads, hand + object; "
                        "hamer: HaMeR's ViT-H/16 trunk and transformer "
                        "decoder, hand only (--backbone, --ncomps and the "
                        "object flags are HOCNet's)")
    g.add_argument("--backbone", default="resnet18",
                   choices=["resnet18", "resnet34", "resnet50"])
    g.add_argument("--ncomps", type=int, default=15, help="MANO PCA comps")
    g.add_argument("--center_idx", type=int, default=9)
    g.add_argument("--freeze_batchnorm", action="store_true", default=True)
    g.add_argument("--no_freeze_batchnorm", dest="freeze_batchnorm",
                   action="store_false")
    g.add_argument("--block_rot", action="store_true",
                   help="freeze object rotation at identity")
    g.add_argument("--obj_rot_param", default="6d", choices=["6d", "axisang"])
    g.add_argument("--bf16", action="store_true", default=True,
                   help="bfloat16 trunk compute (autocast)")
    g.add_argument("--no_bf16", dest="bf16", action="store_false")
    g.add_argument("--mano_lambda_verts3d", type=float, default=0.167)
    g.add_argument("--mano_lambda_joints3d", type=float, default=0.167)
    # 2D reprojection anchors the absolute branch (3D losses are
    # root-centered); 0 leaves trans unsupervised in baseline training.
    g.add_argument("--mano_lambda_joints2d", type=float, default=0.5)
    g.add_argument("--mano_lambda_shape", type=float, default=1e-6)
    g.add_argument("--mano_lambda_pose_reg", type=float, default=1e-6)
    g.add_argument("--obj_lambda_verts3d", type=float, default=0.167)
    g.add_argument("--obj_lambda_verts2d", type=float, default=0.0)
    g.add_argument("--torch_trunk", default="",
                   help="torchvision ResNet .pth: import ImageNet trunk "
                        "weights at init (reference training starts from "
                        "ImageNet)")
    g.add_argument("--torch_ckpt", default="",
                   help="full reference MeshRegNet .pth: import trunk+heads "
                        "(implies --obj_rot_param axisang; use with "
                        "evaluate for MPJPE parity against reference "
                        "checkpoints)")
    g.add_argument("--torch_trunk_prefix", default="base_net.",
                   help="trunk key prefix inside --torch_ckpt")
    g.add_argument("--torch_loose", action="store_true",
                   help="skip head entries missing from --torch_ckpt "
                        "instead of raising (e.g. hand-only checkpoints)")
    g.add_argument("--mano_assets", default="assets/mano",
                   help="dir with MANO_RIGHT.pkl (synthetic model if absent)")
    g.add_argument("--mano_side", default="right", choices=["right", "left"],
                   help="hand side (left loads MANO_LEFT.pkl, else mirrors "
                        "the right model)")


def add_data_opts(p: argparse.ArgumentParser):
    g = p.add_argument_group("data")
    g.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "fhbhands", "ho3dv2"])
    g.add_argument("--data_root", default="")
    g.add_argument("--split", default="train")
    g.add_argument("--val_split", default="test")
    g.add_argument("--image_size", type=int, default=256)
    g.add_argument("--fraction", type=float, default=1.0,
                   help="fraction of annotated frames (sparse supervision)")
    g.add_argument("--spacing", type=int, default=8,
                   help="max temporal offset for frame pairs")
    g.add_argument("--pair_fixed_spacing", action="store_true",
                   help="target frame at EXACTLY --spacing offset (random "
                        "sign) instead of a random offset in [1, spacing] "
                        "(see hocon_torch/data/pairing.py)")
    g.add_argument("--use_objects", action="store_true")
    g.add_argument("--decimate_objects_to", type=int, default=0,
                   help="vertex-clustering face budget for object meshes "
                        "(0 = keep raw)")
    g.add_argument("--synth_videos", type=int, default=8)
    g.add_argument("--synth_frames", type=int, default=8)
    g.add_argument("--uint8_images", action="store_true",
                   help="loaders emit uint8 crops; ImageNet normalization "
                        "runs on-device (4x less host->device transfer; "
                        "<=0.5/255 crop quantization noise)")
    g.add_argument("--check_data", action="store_true",
                   help="parse the dataset tree, pull one sample per "
                        "sequence through the full pipeline, print shapes/"
                        "ranges/anomalies, and exit (1 if any anomaly)")
    g.add_argument("--check_data_seqs", type=int, default=0,
                   help="cap sequences checked by --check_data (0 = all)")


def add_warp_opts(p: argparse.ArgumentParser):
    g = p.add_argument_group("warp")
    g.add_argument("--lambda_consist", type=float, default=1.0)
    g.add_argument("--consist_gt_refs", action="store_true", default=True,
                   help="anchor the warp on GT ref meshes when available")
    g.add_argument("--no_consist_gt_refs", dest="consist_gt_refs",
                   action="store_false")
    g.add_argument("--raster_sigma", type=float, default=1.0)
    g.add_argument("--raster_gamma", type=float, default=1.0 / 40.0)
    g.add_argument("--raster_backend", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="auto / pallas: the culled raster kernels K1 / K2; "
                        "xla: the unculled plain PyTorch raster")
    g.add_argument("--photo_downscale", type=int, default=1,
                   help="compute the photometric term at 1/N resolution "
                        "(1 = reference-faithful full res)")
    g.add_argument("--clip_len", type=int, default=2,
                   help="frames per consistency sample (2 = pairs; >2 = one "
                        "annotated ref + clip_len-1 targets)")


def load_mano_or_synthetic(assets_dir: str, side: str = "right", device=None):
    """User-supplied MANO assets on ``device``, else the synthetic stand-in.

    ``side="left"`` loads ``MANO_LEFT.pkl`` when present, else mirrors the
    right model (``mirror_mano_model``): the right ``.pkl`` if present,
    else the synthetic one.
    """
    from hocon_torch.geometry.mano import (
        load_mano_model,
        mirror_mano_model,
        synthetic_mano_model,
    )

    fname = "MANO_LEFT.pkl" if side == "left" else "MANO_RIGHT.pkl"
    path = os.path.join(assets_dir, fname)
    if os.path.exists(path):
        return load_mano_model(path, side=side, device=device)
    right_path = os.path.join(assets_dir, "MANO_RIGHT.pkl")
    if side == "left" and os.path.exists(right_path):
        return mirror_mano_model(load_mano_model(right_path, side="right", device=device))
    print(
        f"[hocon] MANO assets not found at {path}; using the synthetic "
        "stand-in model (tests/benchmarks only — download MANO for real runs)"
    )
    model = synthetic_mano_model(0, device=device)
    return mirror_mano_model(model) if side == "left" else model
