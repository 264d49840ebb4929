"""The warp's render layer in plain PyTorch: the benchmark's reference.

- ``face_planes``: per-face affine rows (edge distances, along-edge
  coordinates, edge lengths, normalised depth, attributes) with the
  degenerate and backface cull;
- ``soft_rasterize``: the soft rasterizer as its definition states it,
  streamed over face chunks and pixel rows with a max-renormalised softmax,
  at every (face, pixel) pair or, with ``cells``, at the pairs that the
  port's culling keeps; autograd gives its backward (the port's K1 / K2);
- ``bilinear_sample``: the border-clamped bilinear gather (the port's K3 /
  K4), differentiated by autograd in the coordinates;
- ``ssim_loss`` and ``photometric_loss``: masked SSIM + L1, the 11-tap
  Gaussian window as a separable zero-padded convolution.

Per triangle f and pixel q: p = sigmoid(d2 / sigma^2) with d2 the signed
squared distance (+ inside); sil = 1 - prod(1 - p); attributes are the
softmax over faces and background of log p - zbar / gamma; vis = 1 - the
background's share. Imports nothing of ``hocon``, ``hocon_torch`` or JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

AREA_EPS = 1e-6
DEGENERATE_EPS = 1e-12
BACKFACE_MARGIN_FRAC = 0.25
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_depth(z, margin: float = 0.05):
    zmin = torch.amin(z, dim=-1, keepdim=True).detach()
    zmax = torch.amax(z, dim=-1, keepdim=True).detach()
    return (z - zmin) / torch.clamp(zmax - zmin, min=1e-6) * (1.0 - 2.0 * margin) + margin


def _det2d(fv):
    return (fv[..., 1, 0] - fv[..., 0, 0]) * (fv[..., 2, 1] - fv[..., 0, 1]) - (
        fv[..., 2, 0] - fv[..., 0, 0]) * (fv[..., 1, 1] - fv[..., 0, 1])


def face_planes(verts_pix, zbar, faces, attrs, backface_cull: bool):
    """(rows (B, F, 10 + C, 3), valid (B, F)) for faces (F, 3) or (B, F, 3)."""
    data = torch.cat([verts_pix, zbar[..., None], attrs], dim=-1)
    if faces.dim() == 2:
        fall = data[:, faces]
    else:
        fall = data[torch.arange(data.shape[0], device=data.device)[:, None, None], faces]
    fv, fz = fall[..., :2], fall[..., 2]
    # Rows of [x; y; 1] over the three vertices, inverted by the adjugate.
    a, b, c = fv[..., 0, 0], fv[..., 1, 0], fv[..., 2, 0]
    d, e, f = fv[..., 0, 1], fv[..., 1, 1], fv[..., 2, 1]
    g = h = i = torch.ones_like(fz[..., 0])
    adj = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], dim=-2)
    det = _det2d(fv)
    absdet = torch.abs(det)
    valid = absdet > AREA_EPS
    if backface_cull:
        n_valid = torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1)
        margin = BACKFACE_MARGIN_FRAC * (
            torch.sum(torch.where(valid, absdet, 0.0), dim=-1, keepdim=True) / n_valid)
        valid = valid & (det < margin)
    minv = adj / torch.where(absdet > AREA_EPS, det, torch.ones_like(det))[..., None, None]
    edge_rows = minv / torch.sqrt(minv[..., 0] ** 2 + minv[..., 1] ** 2
                                  + DEGENERATE_EPS)[..., None]
    v_a, v_b = fv[:, :, [1, 2, 0], :], fv[:, :, [2, 0, 1], :]  # edge k: v_{k+1} -> v_{k+2}
    e_vec = v_b - v_a
    e_len = torch.sqrt(torch.sum(e_vec ** 2, dim=-1) + DEGENERATE_EPS)
    e_hat = e_vec / e_len[..., None]
    u_rows = torch.cat([e_hat, -torch.sum(v_a * e_hat, dim=-1, keepdim=True)], dim=-1)
    zero = torch.zeros_like(e_len)
    l_rows = torch.stack([zero, zero, e_len], dim=-1)
    z_row = torch.einsum("bfk,bfkc->bfc", fz, minv)[..., None, :]
    a_rows = torch.einsum("bfkc,bfkm->bfcm", fall[..., 3:], minv)
    rows = torch.cat([edge_rows, u_rows, l_rows, z_row, a_rows], dim=-2)
    return rows, valid.to(verts_pix.dtype)


def _chunk(rows, valid, pix, sigma, gamma):
    """One face chunk at one pixel block: (sum log(1 - p), logits, [attrs; zbar]).
    ``valid`` (B, FC) or (B, FC, P) keeps a face, or a (face, pixel) pair."""
    vals = torch.einsum("bfrk,kp->bfrp", rows, pix)
    s, u, length = vals[:, :, 0:3], vals[:, :, 3:6], vals[:, :, 6:9]
    over = torch.clamp(torch.maximum(-u, u - length), min=0.0)
    dist2_out = torch.amin(s * s + over * over, dim=2)
    d_in = torch.amin(s, dim=2)
    signed = torch.where(d_in > 0, d_in * d_in, -dist2_out)
    signed = torch.where((valid if valid.dim() == 3 else valid[..., None]) > 0, signed, -1e18)
    logits = signed / (sigma * sigma)
    sp = F.softplus(-logits)
    zbar = torch.clamp(vals[:, :, 9], 0.0, 1.0)
    interp = torch.cat([vals[:, :, 10:], zbar[:, :, None]], dim=2)
    return (-(logits + sp)).sum(dim=1), -sp - zbar / gamma, interp


def _stream(log_neg, m, num, den, rows, valid, pix, sigma, gamma):
    ln, l, interp = _chunk(rows, valid, pix, sigma, gamma)
    m_new = torch.maximum(m, torch.amax(l, dim=1))
    scale = torch.exp(m - m_new)
    w = torch.exp(l - m_new[:, None])
    num = num * scale[:, None] + torch.einsum("bfp,bfcp->bcp", w, interp)
    den = den * scale + w.sum(dim=1)
    return log_neg + ln, m_new, num, den


def _y_sorted_chunks(verts_pix, faces, valid, image_size, sigma, chunk: int):
    """The port's culling as a (face, pixel) rule: faces sorted by screen-y
    centre (culled last, stable), cut into chunks of ``chunk``; a chunk's
    faces are evaluated at the pixels of every cell (8 rows x a lane block
    of the padded width: all of it up to 256 columns, else 128) that meets
    the chunk's bounding box widened by 3.5 sigma. Returns (the face order,
    hit_y (B, NC, H), hit_x (B, NC, W)) over the image's pixels."""
    vp = verts_pix.detach()
    if faces.dim() == 2:
        fv = vp[:, faces]
    else:
        fv = vp[torch.arange(vp.shape[0], device=vp.device)[:, None, None], faces]
    keep = valid > 0
    ymin, ymax = torch.amin(fv[..., 1], dim=-1), torch.amax(fv[..., 1], dim=-1)
    xmin, xmax = torch.amin(fv[..., 0], dim=-1), torch.amax(fv[..., 0], dim=-1)
    ycen = torch.where(keep, 0.5 * (ymin + ymax), torch.full_like(ymin, float("inf")))
    ycen = torch.where(torch.isnan(ycen), torch.full_like(ycen, float("inf")), ycen)
    order = torch.argsort(ycen, dim=1, stable=True)
    b, nf = keep.shape
    pad = (-nf) % chunk
    nc = (nf + pad) // chunk
    inf = float("inf")
    margin = 3.5 * sigma

    def reduce(v, fill, fn):
        v = torch.where(keep, v, torch.full_like(v, fill))
        v = torch.gather(v, 1, order)
        v = torch.cat([v, v.new_full((b, pad), fill)], dim=1)
        return fn(v.reshape(b, nc, chunk), dim=-1)

    cy0, cy1 = reduce(ymin, inf, torch.amin) - margin, reduce(ymax, -inf, torch.amax) + margin
    cx0, cx1 = reduce(xmin, inf, torch.amin) - margin, reduce(xmax, -inf, torch.amax) + margin
    h, w = image_size
    wp = -(-w // 128) * 128
    lane = wp if wp <= 256 else 128
    dev = vp.device
    y0 = (torch.arange(h, device=dev) // 8 * 8).float()
    x0 = (torch.arange(w, device=dev) // lane * lane).float()
    hit_y = (y0 + 8 > cy0[..., None]) & (y0 < cy1[..., None])
    hit_x = (x0 + lane > cx0[..., None]) & (x0 < cx1[..., None])
    return order, hit_y, hit_x


def soft_rasterize(verts_pix, verts_z, faces, attrs, image_size, sigma, gamma,
                   backface_cull: bool, cells: bool = False, face_chunk: int = 128,
                   pixel_rows: int = 16, checkpoint: bool = True):
    """(sil (B, H, W), attr (B, H, W, C), vis (B, H, W)) of the meshes.

    ``cells`` restricts each face to the pixels at which the port's culling
    evaluates it (``_y_sorted_chunks``, chunks of 32 faces), the only
    approximation the port's kernels make: a pair outside reaches at most
    a coverage of ~4.8e-6. Without it every face is taken at every pixel."""
    rows, valid = face_planes(verts_pix, normalize_depth(verts_z), faces, attrs, backface_cull)
    b, nf, r, _ = rows.shape
    h, w = image_size
    if cells:
        face_chunk = 32
        order, hit_y, hit_x = _y_sorted_chunks(verts_pix, faces, valid, image_size, sigma,
                                               face_chunk)
        rows = torch.gather(rows, 1, order[:, :, None, None].expand_as(rows))
        valid = torch.gather(valid, 1, order)
    n_attr = r - 9  # the user attributes and zbar
    dt, dev = rows.dtype, rows.device
    pad = (-nf) % face_chunk
    rows = F.pad(rows, (0, 0, 0, 0, 0, pad))
    valid = F.pad(valid, (0, pad))
    nc = rows.shape[1] // face_chunk
    ys = torch.arange(h, dtype=dt, device=dev) + 0.5
    xs = torch.arange(w, dtype=dt, device=dev) + 0.5
    l_bg = -1.0 / gamma
    log_negs, aggs, viss = [], [], []
    for y0 in range(0, h, pixel_rows):
        yy = ys[y0:y0 + pixel_rows][:, None].expand(-1, w).reshape(-1)
        xx = xs[None, :].expand(len(yy) // w, w).reshape(-1)
        pix = torch.stack([xx, yy, torch.ones_like(xx)])
        p = pix.shape[-1]
        num = torch.zeros((b, n_attr, p), dtype=dt, device=dev)
        num[:, -1] = 1.0
        carry = (torch.zeros((b, p), dtype=dt, device=dev),
                 torch.full((b, p), l_bg, dtype=dt, device=dev), num,
                 torch.ones((b, p), dtype=dt, device=dev))
        for k in range(nc):
            keep = valid[:, k * face_chunk:(k + 1) * face_chunk]
            if cells:
                take = (hit_y[:, k, y0:y0 + pixel_rows, None] & hit_x[:, k, None, :]).reshape(b, p)
                if not bool(take.any()):
                    continue
                keep = keep[..., None] * take[:, None, :].to(dt)
            args = (*carry, rows[:, k * face_chunk:(k + 1) * face_chunk], keep, pix, sigma, gamma)
            if checkpoint:
                carry = torch.utils.checkpoint.checkpoint(_stream, *args, use_reentrant=False)
            else:
                carry = _stream(*args)
        log_neg, m, num, den = carry
        log_negs.append(log_neg)
        viss.append(1.0 - torch.exp(l_bg - m) / den)
        aggs.append(num / den[:, None])
    sil = 1.0 - torch.exp(torch.cat(log_negs, dim=1).reshape(b, h, w))
    vis = torch.cat(viss, dim=1).reshape(b, h, w)
    agg = torch.cat(aggs, dim=2).reshape(b, n_attr, h, w)
    return sil, agg[:, :-1].permute(0, 2, 3, 1), vis


def bilinear_sample(image, coords):
    """Sample NHWC ``image`` at pixel ``coords`` (B, Hq, Wq, 2), (0.5, 0.5)
    the first pixel's centre, clamped to the border."""
    b, h, w, c = image.shape
    x, y = coords[..., 0] - 0.5, coords[..., 1] - 0.5
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    flat = image.reshape(b, h * w, c)
    bidx = torch.arange(b, device=image.device).view((b,) + (1,) * (x.dim() - 1))

    def tap(dy, dx):
        return flat[bidx, (y0 + dy) * w + (x0 + dx)]

    top = tap(0, 0) * (1 - fx) + tap(0, 1) * fx
    bot = tap(1, 0) * (1 - fx) + tap(1, 1) * fx
    return top * (1 - fy) + bot * fy


def _gauss_taps(window: int, sigma: float, dtype, device):
    x = torch.arange(window, dtype=torch.float64) - (window - 1) / 2.0
    g = torch.exp(-x ** 2 / (2.0 * sigma ** 2))
    return (g / g.sum()).to(dtype=dtype, device=device)


def _window_mean(x, taps):
    """Zero-padded SAME Gaussian mean of (N, 1, H, W), rows then columns."""
    k = taps.numel()
    x = F.conv2d(x, taps.view(1, 1, 1, k), padding=(0, k // 2))
    return F.conv2d(x, taps.view(1, 1, k, 1), padding=(k // 2, 0))


def ssim_map(a, b, window: int = 11, sigma: float = 1.5):
    """Per-pixel SSIM (B, H, W), mean over channels, of NHWC images."""
    n, h, w, c = a.shape
    taps = _gauss_taps(window, sigma, a.dtype, a.device)

    def mean(x):
        return _window_mean(x.permute(0, 3, 1, 2).reshape(n * c, 1, h, w), taps)

    mu_a, mu_b = mean(a), mean(b)
    var_a = mean(a * a) - mu_a * mu_a
    var_b = mean(b * b) - mu_b * mu_b
    cov = mean(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return s.reshape(n, c, h, w).mean(dim=1)


def photometric_loss(warped, target, mask, lambda_ssim=0.85, lambda_l1=0.15):
    """Masked 0.85 DSSIM + 0.15 L1; the mask carries no gradient."""
    mask = mask.detach()
    msum = torch.sum(mask) + 1e-6
    l1 = torch.sum(torch.mean(torch.abs(warped - target), dim=-1) * mask) / msum
    dssim = torch.sum((1.0 - ssim_map(warped, target)) * 0.5 * mask) / msum
    return lambda_ssim * dssim + lambda_l1 * l1, {"photo_l1": l1, "photo_dssim": dssim}


def unnormalize(img):
    mean = img.new_tensor(IMAGENET_MEAN)
    std = img.new_tensor(IMAGENET_STD)
    return torch.clamp(img * std + mean, 0.0, 1.0)
