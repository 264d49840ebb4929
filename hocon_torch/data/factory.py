"""Dataset factory.

Port of ``hocon/data/factory.py``: ``get_dataset`` with the reference's
signature, aliases and defaults, plus ``device`` (see ``hocon_torch.device``):
where a synthetic dataset renders its frames, and where FPHAB / HO-3D frames
given by path are decoded (a JPEG through nvJPEG on the card). The parsers'
MANO forward runs on the device of ``mano``'s tensors.
"""

from __future__ import annotations

import torch

from hocon_torch.data.augment import AugmentConfig
from hocon_torch.data.hand_dataset import HandDataset, HandDatasetConfig


def get_dataset(
    name: str,
    split: str,
    root: str = "",
    image_size: int = 256,
    fraction: float = 1.0,
    use_objects: bool = False,
    pair_mode: bool = False,
    pair_spacing: int = 8,
    pair_fixed_spacing: bool = False,
    clip_len: int = 2,
    train: bool = True,
    mano=None,
    augment: AugmentConfig | None = None,
    max_obj_verts: int = 600,
    max_obj_faces: int = 1000,
    seed: int = 0,
    center_idx: int = 9,
    synth_videos: int = 8,
    synth_frames: int = 8,
    synth_obj_faces: int = 0,
    decimate_objects_to: int = 0,
    uint8_images: bool = False,
    device: str | torch.device | None = None,
) -> HandDataset:
    if name in ("fhbhands", "fphab", "ho3dv2", "ho3d") and use_objects:
        # Raw FPHAB PLY / YCB OBJ meshes exceed the rasterizer's padded
        # buffers (HandDataset raises rather than truncating), so the real
        # datasets decimate to the face cap unless told otherwise.
        decimate_objects_to = decimate_objects_to or max_obj_faces

    if name in ("fhbhands", "fphab"):
        from hocon_torch.data.fphab import FPHAB

        pose_ds = FPHAB(
            root, split=split, fraction=fraction, use_objects=use_objects,
            pair_spacing=pair_spacing, pair_fixed_spacing=pair_fixed_spacing,
            mano=mano, decimate_objects_to=decimate_objects_to or None,
        )
    elif name in ("ho3dv2", "ho3d"):
        from hocon_torch.data.ho3d import HO3D

        pose_ds = HO3D(
            root, split=split, fraction=fraction, use_objects=use_objects,
            pair_spacing=pair_spacing, pair_fixed_spacing=pair_fixed_spacing,
            mano=mano, decimate_objects_to=decimate_objects_to or None,
        )
    elif name == "synthetic":
        from hocon_torch.data.synthetic import SyntheticHandDataset

        pose_ds = SyntheticHandDataset(
            n_videos=synth_videos, frames_per_video=synth_frames,
            image_size=image_size, mano=mano,
            supervised_fraction=fraction if split == "train" else 1.0,
            with_object=use_objects, pair_spacing=pair_spacing,
            pair_fixed_spacing=pair_fixed_spacing, seed=seed,
            obj_n_faces=synth_obj_faces, device=device,
        )
        if use_objects:  # the buffers fit the one synthetic object exactly
            max_obj_verts = len(pose_ds.obj_verts_can)
            max_obj_faces = len(pose_ds.obj_faces)
    else:
        raise ValueError(f"unknown dataset {name!r}")

    if name != "synthetic" and use_objects and decimate_objects_to:
        # decimate_mesh guarantees <= target faces and <= target vertices,
        # so buffers of the budget fit every decimated mesh.
        max_obj_faces = max(max_obj_faces, decimate_objects_to)
        max_obj_verts = max(max_obj_verts, decimate_objects_to)

    cfg = HandDatasetConfig(
        image_size=image_size,
        augment=augment or AugmentConfig(enabled=train),
        pair_mode=pair_mode,
        clip_len=clip_len,
        center_idx=center_idx,
        train=train,
        max_obj_verts=max_obj_verts,
        max_obj_faces=max_obj_faces,
        uint8_images=uint8_images,
        decode_device=device,
    )
    return HandDataset(pose_ds, cfg, seed=seed)
