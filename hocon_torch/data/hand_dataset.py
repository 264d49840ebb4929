"""HandDataset: crop / augment / label wrapper over a pose dataset.

Port of ``hocon/data/hand_dataset.py``, on the host as the reference's is:
crop an ROI around the hand, apply affine and colour jitter, carry the
affine into the 2D labels and the intrinsics, and return a query-keyed
dict of fixed-shape numpy arrays. Pair mode returns (ref, tgt) samples of
one video, the input of photometric-consistency training.

Random order, as the reference's: ``default_rng((seed, i))`` draws the pair
and then every frame's affine jitter; each frame of a pair gets the colour
jitter of its own ``default_rng((seed, i, 7))``, so both frames of a pair
get the same colour jitter.

Frames given by path are read with ``images.read_image`` on the config's
``decode_device`` (a JPEG through nvJPEG on the card); everything else in
``__getitem__`` is host code.

Pose-dataset protocol (duck-typed):
  __len__()
  get_sample(i) -> dict with keys:
    'image'        (H, W, 3) uint8 or float   (or 'image_path')
    'joints3d_cam' (21, 3) float  meters, camera frame
    'verts3d_cam'  (778, 3) float or None
    'camintr'      (3, 3)
    'obj_verts_can'(Vo, 3) or None, 'obj_faces' (Fo, 3), 'obj_pose' (4, 4)
    'supervised'   bool
    'seq_id'       hashable, 'frame_idx' int
  sample_pair(i, rng) -> (ref_index, tgt_index)   [pair mode]
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hocon_torch.data.augment import (
    AugmentConfig,
    color_jitter,
    normalize_image,
    sample_affine_jitter,
)
from hocon_torch.data.cropping import (
    build_crop_affine,
    square_bbox_from_points,
    transform_intrinsics,
    warp_image,
)
from hocon_torch.data.images import read_image
from hocon_torch.data.meshes import bbox_corners
from hocon_torch.data.pipeline import tree_stack
from hocon_torch.data.queries import TransQueries

CENTER_IDX = 9  # middle MCP, reference default for FPHAB


@dataclasses.dataclass
class HandDatasetConfig:
    image_size: int = 256
    bbox_scale: float = 1.3
    center_idx: int = CENTER_IDX
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)
    max_obj_verts: int = 600
    max_obj_faces: int = 1000
    pair_mode: bool = False
    clip_len: int = 2  # frames per sample in pair mode (2 = reference pairs;
    #                    >2 = one annotated ref + clip_len-1 targets)
    train: bool = True
    # Emit crops as uint8 RGB and leave ImageNet normalization to the
    # device (the train steps detect the dtype): 4x less host-to-device
    # transfer, for <= 0.5/255 of crop quantization.
    uint8_images: bool = False
    # Where frames given by 'image_path' are decoded (see images.read_image;
    # None = CUDA). get_dataset sets it to its device.
    decode_device: str | torch.device | None = None


def _project(points3d: np.ndarray, k: np.ndarray) -> np.ndarray:
    hom = points3d @ k.T
    return hom[:, :2] / np.maximum(hom[:, 2:3], 1e-8)


def _load_image(raw: dict, device) -> np.ndarray:
    if raw.get("image") is not None:
        return raw["image"]
    return read_image(raw["image_path"], device)


class HandDataset:
    def __init__(self, pose_dataset, config: HandDatasetConfig | None = None,
                 seed: int = 0, required_queries=None):
        self.pose_dataset = pose_dataset
        self.cfg = config or HandDatasetConfig()
        self._seed = seed
        if required_queries and hasattr(pose_dataset, "available_queries"):
            missing = set(required_queries) - set(pose_dataset.available_queries())
            if missing:
                raise ValueError(
                    f"{type(pose_dataset).__name__} cannot serve queries: "
                    f"{sorted(q.value for q in missing)}"
                )

    def __len__(self):
        return len(self.pose_dataset)

    def _process_frame(
        self,
        raw: dict,
        rng: np.random.Generator,
        color_rng: np.random.Generator | None = None,
    ) -> dict:
        cfg = self.cfg
        image = _load_image(raw, cfg.decode_device).astype(np.float32)
        if image.max() > 2.0:
            image = image / 255.0
        joints3d = np.asarray(raw["joints3d_cam"], np.float32)
        k = np.asarray(raw["camintr"], np.float32)
        joints2d = _project(joints3d, k)

        center, side = square_bbox_from_points(joints2d, cfg.bbox_scale)
        if cfg.train and cfg.augment.enabled:
            scale_j, rot_j, center_j = sample_affine_jitter(rng, cfg.augment, side)
        else:
            scale_j, rot_j, center_j = 1.0, 0.0, np.zeros(2)
        aff = build_crop_affine(center, side, cfg.image_size, rot_j, scale_j, center_j)

        crop = warp_image(image, aff, cfg.image_size)
        if cfg.train and cfg.augment.enabled:
            crop = color_jitter(color_rng if color_rng is not None else rng,
                                crop, cfg.augment)
        if cfg.uint8_images:
            # Jitter can push slightly out of range: clip, then quantize.
            crop = np.clip(crop * 255.0, 0.0, 255.0).round().astype(np.uint8)
        else:
            crop = normalize_image(crop)

        # In-plane rotation jitter hits the 3D labels too: fold the rotation
        # out of the intrinsics (K' = A K Rz^T has no rotation block when
        # fx == fy) and rotate every camera-frame 3D label about the optical
        # axis instead, so pixel(Rz p, K') == A pixel(p, K).
        t = np.deg2rad(rot_j)
        rotz = np.array(
            [[np.cos(t), -np.sin(t), 0.0],
             [np.sin(t), np.cos(t), 0.0],
             [0.0, 0.0, 1.0]],
            np.float64,
        )
        k_adj = (transform_intrinsics(k, aff) @ rotz.T).astype(np.float32)
        joints3d = (joints3d @ rotz.T).astype(np.float32)
        joints2d_adj = _project(joints3d, k_adj).astype(np.float32)

        center3d = joints3d[cfg.center_idx]
        out = {
            TransQueries.IMAGE.value: (
                crop if cfg.uint8_images else crop.astype(np.float32)
            ),
            TransQueries.CAMINTR.value: k_adj,
            TransQueries.JOINTS2D.value: joints2d_adj,
            TransQueries.JOINTS3D.value: (
                (joints3d - center3d) * 1000.0
            ).astype(np.float32),
            TransQueries.JOINTS_CAM.value: joints3d,
            TransQueries.CENTER3D.value: center3d.astype(np.float32),
            TransQueries.SUP_MASK.value: np.float32(
                1.0 if raw.get("supervised", True) else 0.0
            ),
        }
        if raw.get("verts3d_cam") is not None:
            verts3d = np.asarray(raw["verts3d_cam"], np.float32) @ rotz.T
            out[TransQueries.VERTS3D.value] = (
                (verts3d - center3d) * 1000.0
            ).astype(np.float32)

        if raw.get("obj_verts_can") is not None:
            can = np.asarray(raw["obj_verts_can"], np.float32)
            pose = np.asarray(raw["obj_pose"], np.float32)
            faces = np.asarray(raw.get("obj_faces"), np.int64)
            # Truncating a mesh would leave faces pointing at padded zeros:
            # meshes must fit the configured buffers.
            if len(can) > cfg.max_obj_verts or len(faces) > cfg.max_obj_faces:
                raise ValueError(
                    f"object mesh ({len(can)} verts / {len(faces)} faces) "
                    f"exceeds the configured buffers (max_obj_verts="
                    f"{cfg.max_obj_verts}, max_obj_faces="
                    f"{cfg.max_obj_faces}); decimate the mesh or raise the caps"
                )
            nv = len(can)
            can_pad = np.zeros((cfg.max_obj_verts, 3), np.float32)
            can_pad[:nv] = can
            obj_cam = (can_pad @ pose[:3, :3].T + pose[:3, 3]) @ rotz.T
            # Padded faces are degenerate (0,0,0) -> culled by the rasterizer.
            faces_pad = np.zeros((cfg.max_obj_faces, 3), np.int32)
            faces_pad[:len(faces)] = faces
            # Bbox corners from the real (unpadded) vertices, posed like the mesh.
            corners_can = bbox_corners(can[:nv])
            corners_cam = (corners_can @ pose[:3, :3].T + pose[:3, 3]) @ rotz.T
            out[TransQueries.OBJCORNERSCAN.value] = corners_can
            out[TransQueries.OBJCORNERS.value] = (
                (corners_cam - center3d) * 1000.0
            ).astype(np.float32)
            out[TransQueries.OBJVERTSCAN.value] = can_pad
            out["obj_faces"] = faces_pad
            out["obj_nverts"] = np.int32(nv)
            out[TransQueries.OBJVERTS3D.value] = (
                (obj_cam - center3d) * 1000.0
            ).astype(np.float32)
            # Zero out padding rows so the (masked) loss ignores them.
            mask = (np.arange(cfg.max_obj_verts) < nv).astype(np.float32)
            out[TransQueries.OBJVERTS3D.value] *= mask[:, None]
            out["obj_verts_mask"] = mask
        return out

    def __getitem__(self, i: int) -> dict:
        rng = np.random.default_rng((self._seed, i))
        if not self.cfg.pair_mode:
            out = self._process_frame(self.pose_dataset.get_sample(i), rng)
            out["sample_idx"] = np.int64(i)
            return out
        color_seed = (self._seed, i, 7)
        ref_i, tgt_i = self.pose_dataset.sample_pair(i, rng)
        ref = self._process_frame(
            self.pose_dataset.get_sample(ref_i), rng,
            color_rng=np.random.default_rng(color_seed),
        )
        tgts = [tgt_i]
        while len(tgts) < self.cfg.clip_len - 1:
            tgts.append(self.pose_dataset.sample_pair(i, rng)[1])
        processed = [
            self._process_frame(
                self.pose_dataset.get_sample(t), rng,
                color_rng=np.random.default_rng(color_seed),
            )
            for t in tgts
        ]
        if self.cfg.clip_len == 2:  # reference pair layout
            return {"ref": ref, "tgt": processed[0]}
        # k-frame clip: targets stacked along a leading axis.
        return {"ref": ref, "tgt": tree_stack(processed)}
