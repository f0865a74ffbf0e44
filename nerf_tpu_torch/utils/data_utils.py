"""Data and geometry helpers; counterpart of ``nerf_tpu/utils/data_utils.py``.

Two kinds of function, as the JAX package has them:

- host numpy, the same arithmetic as ``nerf_tpu``'s: MVS and NSVF camera
  readers, K and the pose from a projection matrix (numpy RQ), PLY vertices
  (ASCII and binary_little_endian), imagenet normalisation, gaussian
  heatmaps, affine and homography warps, colour augmentation (the caller's
  ``np.random.RandomState``, and python's ``random`` for the order of the
  three jitters, as in ``nerf_tpu``), and the mask helpers;
- tensors on the caller's device: ``heatmap_nms``, ``gather_feat`` and
  ``topk`` (the reference's originals are torch: ``F.max_pool2d``,
  ``torch.gather``, ``torch.topk``).

``nerf_tpu`` calls cv2 in three places; the port computes what cv2 computes,
without it:

- ``resize_image``: the image through the port's bilinear resize
  (``data/blender.py::resize_bilinear``, cv2's INTER_LINEAR), the mask by
  cv2's INTER_NEAREST index rule. As in ``nerf_tpu``, ``input_size`` is
  unpacked as (h, w) to scale the intrinsics but given to the resize as
  cv2's (width, height): ``input_size=(20, 30)`` on a 40x60 image returns a
  30x20 image with fx scaled by 20/40 and fy by 30/60.
- ``draw_poly``: ``cv2.fillPoly(mask, [poly], 255)`` (8-connected, no shift)
  pixel for pixel; see ``draw_poly``.
"""
from __future__ import annotations

import random

import numpy as np

from .vis_utils import mean_rgb, std_rgb

# ---------------------------------------------------------------------------
# camera / matrix file IO


def _matrix_from_lines(lines, rows, cols):
    vals = [float(v) for ln in lines for v in ln.split()]
    return np.asarray(vals, np.float32).reshape(rows, cols)


def read_cam_file(filename):
    """MVSNet-style cam.txt: 'extrinsic' 4x4, 'intrinsic' 3x3, depth line.
    Returns (intrinsics[3,3], extrinsics[4,4], depth_min)."""
    with open(filename) as f:
        lines = [ln.rstrip() for ln in f]
    extrinsics = _matrix_from_lines(lines[1:5], 4, 4)
    intrinsics = _matrix_from_lines(lines[7:10], 3, 3)
    depth_min = float(lines[11].split()[0])
    return intrinsics, extrinsics, depth_min


def read_pmn_cam_file(filename):
    """Like :func:`read_cam_file` but also returns depth_max."""
    intrinsics, extrinsics, depth_min = read_cam_file(filename)
    with open(filename) as f:
        lines = [ln.rstrip() for ln in f]
    depth_max = float(lines[11].split()[1])
    return intrinsics, extrinsics, depth_min, depth_max


def load_matrix(path):
    """Whitespace matrix file; drops 2-column header/footer rows."""
    with open(path) as f:
        rows = [[float(w) for w in ln.split()] for ln in f if ln.strip()]
    if rows and len(rows[0]) == 2:
        rows = rows[1:]
    if rows and len(rows[-1]) == 2:
        rows = rows[:-1]
    return np.asarray(rows, np.float32)


def load_nsvf_intrinsics(filepath, invert_y=False):
    """NSVF intrinsics: a 3x3 / 4x4 / 1x16 matrix file, or a single
    ``f cx cy _`` line. Always returns a 4x4."""
    try:
        m = load_matrix(filepath)
        if m.shape == (3, 3):
            out = np.eye(4, dtype=np.float32)
            out[:3, :3] = m
            return out
        if m.size == 16:
            return m.reshape(4, 4)
        if m.shape == (4, 4):
            return m
    except ValueError:
        pass
    with open(filepath) as f:
        fx, cx, cy, _ = map(float, f.readline().split())
    fy = -fx if invert_y else fx
    out = np.eye(4, dtype=np.float32)
    out[0, 0], out[1, 1], out[0, 2], out[1, 2] = fx, fy, cx, cy
    return out


def _rq(M):
    """RQ decomposition of a 3x3 matrix via a flipped QR."""
    J = np.flipud(np.eye(3, dtype=M.dtype))
    Q, R = np.linalg.qr((J @ M).T)
    return J @ R.T @ J, J @ Q.T  # (upper-triangular, orthonormal)


def load_K_Rt_from_P(filename=None, P=None):
    """Decompose a 3x4 projection matrix P = K [R | t] into intrinsics and
    the camera-to-world pose (R^T, camera centre), by a numpy RQ (what
    cv2.decomposeProjectionMatrix computes). Returns (intrinsics[4,4], pose[4,4])."""
    if P is None:
        with open(filename) as f:
            lines = [ln.split() for ln in f.read().splitlines() if ln]
        if len(lines) == 4:
            lines = lines[1:]
        P = np.asarray([row[:4] for row in lines], np.float32).squeeze()
    P = np.asarray(P, np.float64)
    K, R = _rq(P[:3, :3])
    # fix signs so K's diagonal is positive (absorb into R)
    sign = np.diag(np.sign(np.diag(K)))
    K, R = K @ sign, sign @ R
    if np.linalg.det(R) < 0:
        K, R = -K, -R
    center = -np.linalg.inv(P[:3, :3]) @ P[:3, 3]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K / K[2, 2]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = center
    return intrinsics, pose


_PLY_DTYPES = {
    b"float": "<f4", b"float32": "<f4", b"double": "<f8", b"float64": "<f8",
    b"uchar": "u1", b"uint8": "u1", b"char": "i1", b"int8": "i1",
    b"short": "<i2", b"ushort": "<u2", b"int": "<i4", b"int32": "<i4",
    b"uint": "<u4", b"uint32": "<u4",
}


def load_ply(path):
    """The [N, 3] float32 xyz of a PLY vertex cloud (ascii or binary_little_endian)."""
    with open(path, "rb") as f:
        fmt, n_vertex, fields = None, 0, []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1]
            elif line.startswith(b"element"):
                in_vertex = line.split()[1] == b"vertex"
                if in_vertex:
                    n_vertex = int(line.split()[-1])
            elif line.startswith(b"property") and in_vertex:
                _, typ, name = line.split()[:3]
                fields.append((name.decode(), _PLY_DTYPES[typ]))
            elif line == b"end_header":
                break
        if fmt == b"ascii":
            rows = [f.readline().split() for _ in range(n_vertex)]
            data = np.asarray(rows, np.float64)
            idx = {name: i for i, (name, _) in enumerate(fields)}
            return np.stack([data[:, idx[k]] for k in "xyz"], axis=-1).astype(np.float32)
        rec = np.dtype(fields)
        data = np.frombuffer(f.read(rec.itemsize * n_vertex), rec)
        return np.stack([data[k] for k in "xyz"], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# imagenet-normalized conversion; CHW float <-> HWC uint8


def to_tensor(rgb):
    rgb = rgb.astype(np.float32) / 255.0
    rgb = (rgb - mean_rgb) / std_rgb
    return rgb.transpose(2, 0, 1)


def to_img(chw):
    hwc = np.asarray(chw).transpose(1, 2, 0) * std_rgb + mean_rgb
    return np.clip(hwc * 255.0, 0, 255).astype(np.uint8)


def _resize_linear(img, H, W):
    """cv2.resize(img, (W, H), INTER_LINEAR) through the port's bilinear
    resize: [h, w] or [h, w, C] (C = 1 comes back [H, W], as from cv2); a
    uint8 image is resized in float32 and rounded (cv2 sums 11-bit
    fixed-point weights, so the two may part by one level)."""
    from ..data.blender import resize_bilinear

    img = np.asarray(img)
    x = img.reshape(img.shape[0], img.shape[1], -1)
    out = resize_bilinear(x, H, W)
    out = out[..., 0] if out.shape[-1] == 1 else out
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def _resize_nearest(img, H, W):
    """cv2.resize(img, (W, H), INTER_NEAREST): source index
    min(floor(x * (1 / (W / w))), w - 1) in float64, as cv2's resizeNN."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(H) * (1.0 / (H / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(W) * (1.0 / (W / w))).astype(np.int64), w - 1)
    out = img[ys[:, None], xs[None, :]]
    return out[..., 0] if out.ndim == 3 and out.shape[-1] == 1 else out


def resize_image(img, mask, ixt, input_size):
    """Bilinear image + nearest mask resize, rescaling intrinsics. The output
    is input_size[1] x input_size[0] (cv2's dsize is (width, height)) while
    fx, cx scale by input_size[0] / h and fy, cy by input_size[1] / w, as in
    ``nerf_tpu``: the intrinsics describe the image only when it is square."""
    ori_h, ori_w = img.shape[:2]
    tar_h, tar_w = input_size
    out_w, out_h = input_size
    img = _resize_linear(img, out_h, out_w)
    mask = _resize_nearest(mask.astype(np.uint8), out_h, out_w)
    ixt = np.array(ixt, np.float32)
    ixt[0, [0, 2]] *= tar_h / ori_h
    ixt[1, [1, 2]] *= tar_w / ori_w
    return img, mask, ixt


def resize_images(imgs, masks, ixt, input_size):
    """Vector form of :func:`resize_image` sharing one intrinsic, scaled once
    from the FIRST image's size (the input's ixt for an empty list)."""
    out_i, out_m = [], []
    new_ixt = np.array(ixt, np.float32)
    for i, (img, mask) in enumerate(zip(imgs, masks)):
        img, mask, scaled = resize_image(img, mask, np.array(ixt), input_size)
        if i == 0:
            new_ixt = scaled
        out_i.append(img)
        out_m.append(mask)
    return out_i, out_m, new_ixt


# ---------------------------------------------------------------------------
# gaussian heatmaps (CenterNet)


def gaussian_radius(det_size, min_overlap=0.7):
    """Radius such that any center within it keeps IoU >= min_overlap."""
    h, w = det_size
    # three quadratic cases: both corners move / one inside / one outside
    coeffs = [
        (1.0, h + w, w * h * (1 - min_overlap) / (1 + min_overlap)),
        (4.0, 2 * (h + w), (1 - min_overlap) * w * h),
        (4.0 * min_overlap, -2 * min_overlap * (h + w), (min_overlap - 1) * w * h),
    ]
    radii = []
    for a, b, c in coeffs:
        disc = b * b - 4 * a * c
        if disc < 0:
            continue
        radii.append((b + np.sqrt(disc)) / 2)
    return min(radii)


def gaussian2D(shape, sigma=(1, 1), rho=0.0):
    if not isinstance(sigma, (tuple, list)):
        sigma = (sigma, sigma)
    sx, sy = sigma
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m:m + 1, -n:n + 1]
    energy = (x * x) / (sx * sx) - 2 * rho * x * y / (sx * sy) + (y * y) / (sy * sy)
    h = np.exp(-energy / (2 * (1 - rho * rho)))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def _paste_max(heatmap, gaussian, center, radius, k=1.0):
    """max-composite a (2r+1)² stamp at integer center, cropped to bounds."""
    x, y = int(center[0]), int(center[1])
    H, W = heatmap.shape[:2]
    l, r = min(x, radius), min(W - x, radius + 1)
    t, b = min(y, radius), min(H - y, radius + 1)
    if r + l <= 0 or b + t <= 0:
        return heatmap
    region = heatmap[y - t:y + b, x - l:x + r]
    stamp = gaussian[radius - t:radius + b, radius - l:radius + r]
    np.maximum(region, stamp * k, out=region)
    return heatmap


def draw_umich_gaussian(heatmap, center, radius, k=1):
    d = 2 * radius + 1
    return _paste_max(heatmap, gaussian2D((d, d), sigma=d / 6), center, radius, k)


def draw_distribution(heatmap, center, sigma_x, sigma_y, rho, radius, k=1):
    d = 2 * radius + 1
    g = gaussian2D((d, d), (sigma_x / 3, sigma_y / 3), rho)
    return _paste_max(heatmap, g, center, radius, k)


def draw_heatmap_np(hm, point, box_size):
    """point: [x, y]; stamps a gaussian of radius box_size[0]."""
    radius = max(0, int(box_size[0]))
    return draw_umich_gaussian(hm, np.asarray(point, np.int32), radius)


def compute_gaussian_1d(dmap, sigma=1):
    """dmap entries are distances; returns unnormalized gaussian probs."""
    prob = np.exp(-dmap / (2 * sigma * sigma))
    prob[prob < np.finfo(prob.dtype).eps * prob.max()] = 0
    return prob


# ---------------------------------------------------------------------------
# affine / homography warps


def get_3rd_point(a, b):
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return [src_point[0] * cs - src_point[1] * sn,
            src_point[0] * sn + src_point[1] * cs]


def _solve_affine(src, dst):
    """2x3 affine mapping three src points onto three dst points."""
    A = np.concatenate([src, np.ones((3, 1), np.float32)], axis=1)
    return np.linalg.solve(A, dst).T.astype(np.float32)  # [2,3]


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0, 0], dtype=np.float32), inv=0):
    """Center/scale/rotation crop transform (CenterNet convention)."""
    if not isinstance(scale, (np.ndarray, list)):
        scale = np.array([scale, scale], dtype=np.float32)
    src_w, (dst_w, dst_h) = scale[0], output_size
    rot_rad = np.pi * rot / 180
    src_dir = get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = get_3rd_point(src[0], src[1])
    dst[2] = get_3rd_point(dst[0], dst[1])
    return _solve_affine(dst, src) if inv else _solve_affine(src, dst)


def affine_transform(pt, t):
    """pt: [n, 2] through a 2x3 affine."""
    return np.asarray(pt) @ t[:, :2].T + t[:, 2]


def homography_transform(pt, H):
    """pt: [n, 2] through a 3x3 homography (perspective divide)."""
    pt = np.concatenate([pt, np.ones([len(pt), 1])], axis=1) @ H.T
    return pt[..., :2] / pt[..., 2:]


def get_border(border, size):
    """Largest border//2^k that leaves an interior."""
    i = 1
    while np.any(size - border // i <= border // i):
        i *= 2
    return border // i


def clip_to_image(bbox, h, w):
    """Clamp [x1,y1,x2,y2] boxes to image bounds (in place, numpy)."""
    bbox = np.asarray(bbox)
    bbox[..., :2] = np.maximum(bbox[..., :2], 0)
    bbox[..., 2] = np.minimum(bbox[..., 2], w - 1)
    bbox[..., 3] = np.minimum(bbox[..., 3], h - 1)
    return bbox


# ---------------------------------------------------------------------------
# photometric augmentation; images are float HWC, changed in place


def grayscale(image):
    """BT.601 luma of a BGR image (cv2's BGR->GRAY weights)."""
    b, g, r = image[..., 0], image[..., 1], image[..., 2]
    return 0.114 * b + 0.587 * g + 0.299 * r


def blend_(alpha, image1, image2):
    image1 *= alpha
    image1 += image2 * (1 - alpha)


def lighting_(data_rng, image, alphastd, eigval, eigvec):
    alpha = data_rng.normal(scale=alphastd, size=(3,))
    image += np.dot(eigvec, eigval * alpha)


def saturation_(data_rng, image, gs, gs_mean, var):
    blend_(1.0 + data_rng.uniform(-var, var), image, gs[:, :, None])


def brightness_(data_rng, image, gs, gs_mean, var):
    image *= 1.0 + data_rng.uniform(-var, var)


def contrast_(data_rng, image, gs, gs_mean, var):
    blend_(1.0 + data_rng.uniform(-var, var), image, gs_mean)


def color_aug(data_rng, image, eig_val, eig_vec):
    """Brightness, contrast and saturation in an order drawn from python's
    ``random``, their strengths and the lighting from ``data_rng``."""
    fns = [brightness_, contrast_, saturation_]
    random.shuffle(fns)
    gs = grayscale(image)
    gs_mean = gs.mean()
    for f in fns:
        f(data_rng, image, gs, gs_mean, 0.4)
    lighting_(data_rng, image, 0.1, eig_val, eig_vec)


def gaussian_blur(image, sigma):
    """Per-channel gaussian blur, mirror boundary, in place."""
    from scipy import ndimage

    if image.ndim == 2:
        image[:, :] = ndimage.gaussian_filter(image, sigma, mode="mirror")
    else:
        for c in range(image.shape[2]):
            image[:, :, c] = ndimage.gaussian_filter(image[:, :, c], sigma, mode="mirror")
    return image


def truncated_normal(mean, sigma, low, high, data_rng=None):
    if data_rng is None:
        data_rng = np.random.RandomState()
    return np.clip(data_rng.normal(mean, sigma), low, high)


# ---------------------------------------------------------------------------
# detection post-processing: tensors on the caller's device


def heatmap_nms(heat, kernel=3):
    """Keep only the local maxima of [b, c, h, w] heatmaps: a value survives
    where it equals the largest value of its kernel x kernel window, zeros
    elsewhere. The border is padded with zeros (scipy's maximum_filter in
    mode "constant", as ``nerf_tpu``), not with F.max_pool2d's -inf, so a
    negative value next to the border never survives; an even kernel's
    window reaches kernel // 2 back and (kernel - 1) // 2 forward, as scipy's."""
    import torch.nn.functional as F

    lo, hi = kernel // 2, (kernel - 1) // 2
    hmax = F.max_pool2d(F.pad(heat, (lo, hi, lo, hi), value=0.0), kernel, stride=1)
    return heat * (hmax == heat)


def gather_feat(feat, ind):
    """feat [b, n, d] gathered at ind [b, k] -> [b, k, d]."""
    import torch

    return torch.gather(feat, 1, ind.unsqueeze(-1).expand(-1, -1, feat.shape[2]))


def topk(scores, K=40):
    """Top-K peaks of [b, c, h, w] score maps: the K best of each class, then
    the K best of those. Returns (score, inds, clses, ys, xs), each [b, K],
    score descending: score in scores' dtype, inds (y * w + x) int64, clses
    int32, ys and xs float32. Where values tie, which of them comes first
    (and which is kept at the K-th place) is unspecified, here as in
    ``nerf_tpu``; values without ties give the same result as it."""
    import torch

    b, c, h, w = scores.shape
    topk_scores, topk_inds = torch.topk(scores.reshape(b, c, -1), K, dim=2)  # [b, c, K]
    ys = torch.div(topk_inds, w, rounding_mode="floor").float()
    xs = (topk_inds % w).float()
    topk_score, topk_ind = torch.topk(topk_scores.reshape(b, -1), K, dim=1)  # [b, K]
    topk_clses = torch.div(topk_ind, K, rounding_mode="floor").int()

    def sel(a):
        return gather_feat(a.reshape(b, -1, 1), topk_ind)[..., 0]

    return topk_score, sel(topk_inds).long(), topk_clses, sel(ys), sel(xs)


# ---------------------------------------------------------------------------
# masks and polygons

XY_SHIFT = 16  # cv2's fixed point for polygon edges: 16.16


def inter_from_mask(pred, gt):
    return np.logical_and(pred.astype(bool), gt.astype(bool)).sum()


def _clip_line(w, h, p1, p2):
    """cv2.clipLine to [0, w-1] x [0, h-1] (integer ends, each shift of an
    end truncated toward zero from double). Returns (inside, p1, p2)."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _inside(w, h, p1, p2):
    return 0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h


def line_pixels(p1, p2, h, w):
    """(ys, xs) of cv2's 8-connected line from p1 to p2 on an h x w image:
    the ends clipped by ``_clip_line`` where one lies outside, the line run
    left to right, and Bresenham's decision (err = dx - 2 dy, minor step
    where err < 0) in closed form: step k of the major axis moves the minor
    one by ceil((2 minor k - major) / (2 major))."""
    if not _inside(w, h, p1, p2):
        ok, p1, p2 = _clip_line(w, h, p1, p2)
        if not ok:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    m = -((major - 2 * minor * k) // (2 * major)) if major else np.zeros_like(k)
    if vert:
        return y1 + sy * k, x1 + m
    return y1 + sy * m, x1 + k


def draw_poly(mask, poly):
    """``cv2.fillPoly(mask, [poly], 255)`` (LINE_8, shift 0) without cv2.

    cv2's rule, reproduced pixel for pixel (convex, concave, self-crossing
    and border-crossing polygons alike):

    1. each edge's outline drawn as ``line_pixels`` between its ends;
    2. each non-horizontal edge (ends (x0, y0), (x1, y1), y0 < y1) made a
       16.16 fixed-point edge over the rows y0 <= y < y1: where both ends lie
       in the image it starts at x0 << 16 at y0 with the step dx =
       ((x1 - x0) << 16) / (y1 - y0), truncated toward zero; otherwise the
       edge is clipped as its outline is (``_clip_line``), its step taken
       from the clipped ends (their x, and their y where they differ) and
       its start moved back along that step to y0;
    3. on each row, the active edges' x sorted and paired, first with
       second, third with fourth (even-odd), and each pair (xl, xr) fills
       ceil(xl) .. floor(xr) where that span is not empty, drawn only if it
       starts left of the right border and ends right of the left one, then
       clamped to the image.

    ``mask`` is changed in place and returned; on a multi-channel mask the
    colour is cv2's Scalar(255): 255 in channel 0, 0 in the others."""
    h, w = mask.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(poly, np.int32).reshape(-1, 2)]
    if not pts:
        return mask
    ys_l, xs_l, edges = [], [], []
    one = 1 << XY_SHIFT
    for (xa, ya), (xb, yb) in zip(pts[-1:] + pts[:-1], pts):
        t0, t1 = (xa, ya), (xb, yb)
        ly, lx = line_pixels(t0, t1, h, w)
        ys_l.append(ly)
        xs_l.append(lx)
        if ya == yb:
            continue
        c0, c1 = (xa << XY_SHIFT, ya), (xb << XY_SHIFT, yb)
        if not _inside(w, h, t0, t1):
            _, k0, k1 = _clip_line(w, h, t0, t1)
            if k0[1] != k1[1]:
                c0, c1 = (c0[0], k0[1]), (c1[0], k1[1])
            c0, c1 = (k0[0] << XY_SHIFT, c0[1]), (k1[0] << XY_SHIFT, c1[1])
        num, den = c1[0] - c0[0], c1[1] - c0[1]
        step = abs(num) // abs(den) * (1 if (num >= 0) == (den >= 0) else -1)
        if ya < yb:
            edges.append((ya, yb, c0[0] + (ya - c0[1]) * step, step))
        else:
            edges.append((yb, ya, c1[0] + (yb - c1[1]) * step, step))
    ys = [np.concatenate(ys_l)]
    xs = [np.concatenate(xs_l)]
    if len(edges) >= 2:
        e = np.asarray(edges, np.int64)
        y0, y1, x0, step = e.T
        x_end = x0 + (y1 - y0) * step
        if not (y1.max() < 0 or y0.min() >= h or max(x0.max(), x_end.max()) < 0
                or min(x0.min(), x_end.min()) >= (w << XY_SHIFT)):
            rows = np.arange(max(int(y0.min()), 0), min(int(y1.max()), h), dtype=np.int64)
            x = x0[:, None] + (rows[None, :] - y0[:, None]) * step[:, None]
            active = (y0[:, None] <= rows[None, :]) & (rows[None, :] < y1[:, None])
            big = np.iinfo(np.int64).max
            x = np.sort(np.where(active, x, big), axis=0)
            pairs = len(edges) // 2
            left, right = x[0:2 * pairs:2], x[1:2 * pairs:2]
            lo = (left + (one - 1)) >> XY_SHIFT
            hi = right >> XY_SHIFT
            draw = (right != big) & (lo <= hi) & (lo < w) & (hi >= 0)
            lo, hi = np.maximum(lo, 0), np.minimum(hi, w - 1)
            r = np.broadcast_to(rows[None, :], lo.shape)[draw]
            lo, hi = lo[draw], hi[draw]
            n = hi - lo + 1
            span_rows = np.repeat(r, n)
            ys.append(span_rows)
            xs.append(np.repeat(lo, n) + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n))
    ys, xs = np.concatenate(ys), np.concatenate(xs)
    if mask.ndim == 2:
        mask[ys, xs] = 255
    else:
        mask[ys, xs, 0] = 255
        mask[ys, xs, 1:] = 0
    return mask


def inter_from_poly(poly, gt, width, height):
    mask_small = draw_poly(np.zeros((height, width), np.uint8), poly)
    return inter_from_mask(mask_small, gt[..., 0] if gt.ndim == 3 else gt)


def get_edge(mask):
    """Mask minus its 3x3 erosion = one-pixel inner edge."""
    from scipy import ndimage

    eroded = ndimage.grey_erosion(mask, size=(3, 3))
    return mask - eroded
