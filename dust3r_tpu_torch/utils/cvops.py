"""The OpenCV calls of the offline preprocess scripts, in numpy (and PIL for
the files), each matching the cv2 function it is named after.

The JAX package's `datasets_preprocess/` scripts call cv2; the port carries
none, so each call they make is reproduced here, to the bit where cv2's
arithmetic allows it (the tests hold each one against cv2):

  resize_area               cv2.resize(..., INTER_AREA) on uint8, both of
                            cv2's paths: an integer factor (the block mean;
                            2x2 rounds (s + 2) >> 2, others the float32
                            product s * (1 / area)), and the weighted path of
                            other factors (float32 tap tables, rows then
                            columns in cv2's order), rounded half to even
  resize_nearest            cv2.resize(..., INTER_NEAREST) (`cropping`'s)
  resize_nearest_exact      cv2.resize(..., INTER_NEAREST_EXACT) of the x86
                            wheels (IPP): pixel centres accumulated in float64
  rotate, flip, rodrigues   cv2.rotate, cv2.flip (vertical), cv2.Rodrigues
                            (vector to matrix)
  get_optimal_new_camera_matrix, init_undistort_rectify_map
                            the pinhole (radial-tangential) model's
                            (centred principal point; R the identity)
  fisheye_estimate_new_camera_matrix, fisheye_init_undistort_rectify_map
                            cv2.fisheye's, for the equidistant model (R
                            the identity)
  remap                     cv2.remap with float32 maps: INTER_NEAREST (the
                            map rounded half to even) and INTER_LINEAR (two
                            fused multiply-adds along x, one along y, in
                            float32, on the unquantized map; uint8 rounded
                            half to even), borders BORDER_CONSTANT (with its
                            value), BORDER_REFLECT_101 and BORDER_WRAP
  imwrite                   cv2.imwrite for PNG (uint8 one- or three-channel
                            BGR, uint16) and JPEG (quality 95, cv2's
                            default), written with PIL: the PNG pixels equal
                            cv2's (not its bytes); the JPEG bytes were
                            cv2's in every test, which no API promises

The maps' float32 values and the undistortion's float64 math follow
OpenCV's own sources; where cv2 accumulates a map's coordinates along a row
these are computed per pixel, so the maps need not be cv2's bits (the tests
hold them to 1e-4 px). The rules are those of the x86 opencv-python 5.0.0
wheel the JAX scripts run on: its INTER_NEAREST_EXACT is IPP's and its
float-map remap lerps with FMAs, where OpenCV's own sources round to 16.16
fixed point and to 1/32 px tables.
"""
from __future__ import annotations

import math
import os

import numpy as np

from ..datasets.utils.cropping import resize_nearest

__all__ = ["resize_area", "resize_nearest", "resize_nearest_exact", "rotate", "flip",
           "rodrigues", "get_optimal_new_camera_matrix", "init_undistort_rectify_map",
           "fisheye_estimate_new_camera_matrix", "fisheye_init_undistort_rectify_map",
           "remap", "imwrite"]

# cv2's constants, by value
INTER_NEAREST, INTER_LINEAR, INTER_AREA, INTER_NEAREST_EXACT = 0, 1, 3, 6
BORDER_CONSTANT, BORDER_WRAP, BORDER_REFLECT_101 = 0, 3, 4
ROTATE_90_CLOCKWISE, ROTATE_180, ROTATE_90_COUNTERCLOCKWISE = 0, 1, 2
JPEG_QUALITY = 95  # cv2.imwrite's default IMWRITE_JPEG_QUALITY
_DBL_EPSILON = np.finfo(np.float64).eps


def _round_u8(x):
    """saturate_cast<uchar>(float): round half to even, clamp to [0, 255]."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _area_tab(ssize, dsize, scale):
    """OpenCV's computeResizeAreaTab for one axis, as (dsize, taps) arrays
    of source indices and float32 weights, each row's taps in cv2's order
    (weight 0 pads a row)."""
    rows = []
    for d in range(dsize):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - fs1 > 1e-3:
            taps.append((s1 - 1, np.float32((s1 - fs1) / cell)))
        taps += [(s, np.float32(1.0 / cell)) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            taps.append((s2, np.float32(min(min(fs2 - s2, 1.0), cell) / cell)))
        rows.append(taps)
    n = max(len(t) for t in rows)
    idx = np.zeros((dsize, n), np.int64)
    w = np.zeros((dsize, n), np.float32)
    for d, taps in enumerate(rows):
        for t, (s, a) in enumerate(taps):
            idx[d, t], w[d, t] = s, a
    return idx, w


def resize_area(img, size):
    """`cv2.resize(img, size, interpolation=cv2.INTER_AREA)` for a uint8 (H,
    W) or (H, W, C) image shrunk to size = (W, H) (no axis grown), bit for
    bit."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_area takes uint8, not {img.dtype}")
    dw, dh = (int(s) for s in size)
    sh, sw = img.shape[:2]
    if dw > sw or dh > sh:
        raise ValueError(f"resize_area shrinks: {sw}x{sh} -> {dw}x{dh}")
    src = img if img.ndim == 3 else img[..., None]
    cn = src.shape[2]
    scale_x, scale_y = 1.0 / (dw / sw), 1.0 / (dh / sh)  # as cv2 computes them
    ix, iy = int(round(scale_x)), int(round(scale_y))
    if abs(scale_x - ix) < _DBL_EPSILON and abs(scale_y - iy) < _DBL_EPSILON:
        # the block mean of cv2's resizeAreaFast (the sizes divide exactly)
        blocks = src[:dh * iy, :dw * ix].reshape(dh, iy, dw, ix, cn).astype(np.int64)
        s = blocks.sum(axis=(1, 3))
        if ix == iy == 2 and cn in (1, 3, 4):
            out = ((s + 2) >> 2).astype(np.uint8)
        else:
            out = _round_u8(s.astype(np.float32) * np.float32(1.0 / (ix * iy)))
    else:
        xi, xw = _area_tab(sw, dw, scale_x)
        yi, yw = _area_tab(sh, dh, scale_y)
        S = src.astype(np.float32)
        buf = np.zeros((sh, dw, cn), np.float32)
        for t in range(xi.shape[1]):  # each source row's column sums, in cv2's order
            buf += S[:, xi[:, t]] * xw[:, t, None]
        acc = yw[:, 0, None, None] * buf[yi[:, 0]]
        for t in range(1, yi.shape[1]):
            acc += yw[:, t, None, None] * buf[yi[:, t]]
        out = _round_u8(acc)
    return out if img.ndim == 3 else out[..., 0]


def resize_nearest_exact(img, size):
    """`cv2.resize(img, size, interpolation=cv2.INTER_NEAREST_EXACT)`, size =
    (W, H), as the x86 OpenCV wheels compute it (their IPP resize): the
    source index of output x is floor(p_x), p_0 = s / 2 and p_(x+1) = p_x +
    s accumulated in float64, s = source / output size. At a pixel centre
    that lands exactly on a source edge the accumulated rounding picks the
    side, so it differs there from OpenCV's own 16.16 fixed-point rule."""
    img = np.asarray(img)
    dw, dh = (int(s) for s in size)
    sh, sw = img.shape[:2]

    def index(s, d):
        step = s / d
        pos = np.add.accumulate(np.r_[0.5 * step, np.full(d - 1, step)])  # sequential sums
        return np.minimum(np.floor(pos).astype(np.int64), s - 1)

    return img[index(sh, dh)][:, index(sw, dw)]


def rotate(img, code):
    """`cv2.rotate(img, code)`."""
    img = np.asarray(img)
    if code == ROTATE_90_CLOCKWISE:
        return np.ascontiguousarray(np.rot90(img, -1))
    if code == ROTATE_90_COUNTERCLOCKWISE:
        return np.ascontiguousarray(np.rot90(img, 1))
    if code == ROTATE_180:
        return np.ascontiguousarray(img[::-1, ::-1])
    raise ValueError(f"rotate code {code}")


def flip(img, code):
    """`cv2.flip(img, 0)`: the rows reversed (the PFM reader's flip; other
    codes are not used)."""
    if code != 0:
        raise ValueError(f"flip code {code}: only 0 (vertical)")
    return np.ascontiguousarray(np.asarray(img)[::-1])


def rodrigues(rvec):
    """`cv2.Rodrigues(rvec)[0]`: a rotation vector -> its 3x3 matrix,
    cos(θ) I + (1 - cos(θ)) r rᵀ + sin(θ) [r]ₓ for the unit axis r (float64)."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = math.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    if theta < _DBL_EPSILON:
        return np.eye(3)
    c, s = math.cos(theta), math.sin(theta)
    rx, ry, rz = r * (1.0 / theta)
    rrt = np.array([[rx * rx, rx * ry, rx * rz], [rx * ry, ry * ry, ry * rz],
                    [rx * rz, ry * rz, rz * rz]])
    r_x = np.array([[0, -rz, ry], [rz, 0, -rx], [-ry, rx, 0]])
    return c * np.eye(3) + (1 - c) * rrt + s * r_x


def _undistort_rectangles(K, dist, size):
    """OpenCV's getUndistortRectangles through K: a 9x9 grid of image
    points undistorted; returns the inner and outer (x, y, w, h)
    rectangles."""
    from ..visloc.localization import undistort_points

    W, H = size
    n = 9
    gx, gy = np.meshgrid(np.arange(n) * (W - 1) / (n - 1), np.arange(n) * (H - 1) / (n - 1))
    pts = undistort_points(np.stack([gx, gy], -1).reshape(-1, 2), K, dist).reshape(n, n, 2)
    x, y = pts[..., 0], pts[..., 1]
    ix0, ix1 = x[:, 0].max(), x[:, -1].min()
    iy0, iy1 = y[0].max(), y[-1].min()
    ox0, ox1, oy0, oy1 = x.min(), x.max(), y.min(), y.max()
    return (ix0, iy0, ix1 - ix0, iy1 - iy0), (ox0, oy0, ox1 - ox0, oy1 - oy0)


def _dist_vector(dist):
    d = np.asarray(dist, np.float64).ravel()
    if len(d) not in (4, 5, 8, 12):
        raise ValueError(f"{len(d)} distortion coefficients: 4, 5, 8 or 12 are supported")
    return d


def get_optimal_new_camera_matrix(K, dist, size, alpha, new_size=None):
    """`cv2.getOptimalNewCameraMatrix(K, dist, size, alpha, new_size,
    centerPrincipalPoint=True)[0]` (size, new_size = (W, H)), the scripts'
    form: the principal point at the new image's centre pixel, the focal
    scaled so that alpha 0 keeps only valid pixels and alpha 1 every source
    pixel."""
    K = np.asarray(K, np.float64)
    d = _dist_vector(dist)
    new_size = tuple(size) if not new_size or new_size[0] * new_size[1] == 0 else tuple(new_size)
    cx0, cy0 = K[0, 2], K[1, 2]
    cx, cy = (new_size[0] - 1) * 0.5, (new_size[1] - 1) * 0.5
    (ix, iy, iw, ih), (ox, oy, ow, oh) = _undistort_rectangles(K, d, size)
    s0 = max(cx / (cx0 - ix), cy / (cy0 - iy), cx / (ix + iw - cx0), cy / (iy + ih - cy0))
    s1 = min(cx / (cx0 - ox), cy / (cy0 - oy), cx / (ox + ow - cx0), cy / (oy + oh - cy0))
    s = s0 * (1 - alpha) + s1 * alpha
    M = K.copy()
    M[0, 0] *= s
    M[1, 1] *= s
    M[0, 2], M[1, 2] = cx, cy
    return M


def _rays(newK, size):
    """(x, y, w) of every output pixel through inv(newK)."""
    W, H = size
    iR = np.linalg.inv(np.asarray(newK, np.float64)[:, :3])
    j, i = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    return (j * iR[0, 0] + i * iR[0, 1] + iR[0, 2], j * iR[1, 0] + i * iR[1, 1] + iR[1, 2],
            j * iR[2, 0] + i * iR[2, 1] + iR[2, 2])


def init_undistort_rectify_map(K, dist, newK, size):
    """`cv2.initUndistortRectifyMap(K, dist, np.eye(3), newK, size,
    cv2.CV_32FC1)`:
    (map_x, map_y) float32 (H, W), the distorted source pixel of each
    output pixel (radial k1-k6, tangential p1, p2, thin prism s1-s4)."""
    K = np.asarray(K, np.float64)
    k = np.zeros(12)
    d = _dist_vector(dist)
    k[:len(d)] = d
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = k
    X, Y, Wh = _rays(newK, size)
    w = 1.0 / Wh
    x, y = X * w, Y * w
    x2, y2 = x * x, y * y
    r2, _2xy = x2 + y2, 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2) + s1 * r2 + s2 * r2 * r2
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy + s3 * r2 + s4 * r2 * r2
    u = K[0, 0] * xd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


def _fisheye_distort_scale(r, k):
    """θ_d / r of the equidistant model at radius r (1 at r = 0)."""
    theta = np.arctan(r)
    t2 = theta * theta
    t4 = t2 * t2
    theta_d = theta * (1 + k[0] * t2 + k[1] * t4 + k[2] * t4 * t2 + k[3] * t4 * t4)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(r == 0, 1.0, theta_d / r)


def fisheye_init_undistort_rectify_map(K, dist, newK, size):
    """`cv2.fisheye.initUndistortRectifyMap(K, dist, np.eye(3), newK, size,
    cv2.CV_32FC1)`: (map_x, map_y) float32 (H, W); a ray behind the camera
    maps to -inf / +inf as in cv2."""
    K = np.asarray(K, np.float64)
    k = _dist_vector(dist)[:4]
    X, Y, Wh = _rays(newK, size)
    behind = Wh <= 0
    with np.errstate(invalid="ignore", divide="ignore"):
        x, y = X / Wh, Y / Wh
    scale = _fisheye_distort_scale(np.sqrt(x * x + y * y), k)
    u = np.where(behind, np.where(X > 0, -np.inf, np.inf), K[0, 0] * x * scale + K[0, 2])
    v = np.where(behind, np.where(Y > 0, -np.inf, np.inf), K[1, 1] * y * scale + K[1, 2])
    return u.astype(np.float32), v.astype(np.float32)


def _fisheye_undistort_points(pts, K, k, iterations=10, eps=1e-8):
    """cv2.fisheye.undistortPoints(pts, K, k) (R = P = identity), its default
    criteria: Newton's method on θ for 10 steps or until a step is < 1e-8;
    a point whose θ flips sign comes back as (-1e6, -1e6)."""
    pw = (np.asarray(pts, np.float64) - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    out = []
    for x, y in pw:
        theta_d = min(max(-math.pi / 2, math.sqrt(x * x + y * y)), math.pi / 2)
        theta, converged, scale = theta_d, False, 0.0
        if abs(theta_d) > eps:
            for _ in range(iterations):
                t2 = theta * theta
                t4 = t2 * t2
                t6, t8 = t4 * t2, t4 * t4
                k0t2, k1t4, k2t6, k3t8 = k[0] * t2, k[1] * t4, k[2] * t6, k[3] * t8
                fix = (theta * (1 + k0t2 + k1t4 + k2t6 + k3t8) - theta_d) / \
                    (1 + 3 * k0t2 + 5 * k1t4 + 7 * k2t6 + 9 * k3t8)
                theta -= fix
                if abs(fix) < eps:
                    converged = True
                    break
            scale = math.tan(theta) / theta_d
        else:
            converged = True
        flipped = (theta_d < 0 < theta) or (theta < 0 < theta_d)
        out.append((x * scale, y * scale) if converged and not flipped else (-1e6, -1e6))
    return np.array(out)


def fisheye_estimate_new_camera_matrix(K, dist, size, balance=0.0):
    """`cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(K, dist, size,
    np.eye(3), balance=balance)`: the focal that fits the undistorted edge
    midpoints, between the tightest (balance 0) and the loosest (balance
    1)."""
    K = np.asarray(K, np.float64)
    k = _dist_vector(dist)[:4]
    w, h = size
    balance = min(max(balance, 0.0), 1.0)
    pts = _fisheye_undistort_points([(w // 2, 0), (w, h // 2), (w // 2, h), (0, h // 2)], K, k)
    cn = pts.mean(axis=0)
    aspect = K[0, 0] / K[1, 1]
    cn[1] *= aspect
    pts[:, 1] *= aspect
    minx, maxx = pts[:, 0].min(), pts[:, 0].max()
    miny, maxy = pts[:, 1].min(), pts[:, 1].max()
    f1 = w * 0.5 / (cn[0] - minx)
    f2 = w * 0.5 / (maxx - cn[0])
    f3 = h * 0.5 * aspect / (cn[1] - miny)
    f4 = h * 0.5 * aspect / (maxy - cn[1])
    fmin, fmax = min(f1, f2, f3, f4), max(f1, f2, f3, f4)
    f = balance * fmin + (1.0 - balance) * fmax
    new_f = np.array([f, f])
    new_c = -cn * f + np.array([w, h * aspect]) * 0.5
    new_f[1] /= aspect
    new_c[1] /= aspect
    return np.array([[new_f[0], 0, new_c[0]], [0, new_f[1], new_c[1]], [0, 0, 1]])


def _fma32(a, b, c):
    """float32 a * b + c rounded once (a fused multiply-add). The product is
    exact in float64, and the float64 sum s is the exact sum rounded: only
    where s lands exactly on a float32 tie (the low 29 bits of its mantissa
    are 1 << 28) can that first rounding move the second; there the sign of
    s's rounding error decides."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    r = s.astype(np.float32)
    tie = (s.view(np.uint64) & np.uint64((1 << 29) - 1)) == np.uint64(1 << 28)
    if tie.any():
        ps, cs, ss = np.broadcast_to(p, s.shape)[tie], np.broadcast_to(c, s.shape)[tie], s[tie]
        bb = ss - ps
        err = (ps - (ss - bb)) + (cs - bb)  # ss + err == ps + cs exactly
        lo = np.nextafter(r[tie], np.float32(-np.inf))
        hi = np.nextafter(r[tie], np.float32(np.inf))
        below = np.where(r[tie] > ss, lo, r[tie])  # the float32 tie's two sides
        above = np.where(r[tie] > ss, r[tie], hi)
        r[tie] = np.where(err > 0, above, np.where(err < 0, below, r[tie]))
    return r


def _border_index(p, n, mode):
    """OpenCV's borderInterpolate, vectorized; BORDER_CONSTANT gives -1
    outside."""
    inside = (p >= 0) & (p < n)
    if mode == BORDER_CONSTANT:
        return np.where(inside, p, -1)
    if mode == BORDER_WRAP:
        return np.mod(p, n)
    if mode == BORDER_REFLECT_101:
        if n == 1:
            return np.zeros_like(p)
        q = np.mod(p, 2 * (n - 1))
        return np.where(q >= n, 2 * (n - 1) - q, q)
    raise ValueError(f"border mode {mode}")


def _gather(src, iy, ix, mode, value):
    """src[iy, ix] with OpenCV's border rule; BORDER_CONSTANT's outside taps
    take `value` (a scalar or one value per channel)."""
    H, W = src.shape[:2]
    outside = (iy < 0) | (iy >= H) | (ix < 0) | (ix >= W)
    by, bx = iy, ix
    if outside.any():
        by, bx = iy.copy(), ix.copy()
        by[outside] = _border_index(iy[outside], H, mode)
        bx[outside] = _border_index(ix[outside], W, mode)
        outside = (by < 0) | (bx < 0)  # BORDER_CONSTANT's taps off the image
    flat = src.reshape(H * W, *src.shape[2:])
    out = flat.take(np.maximum(by, 0) * W + np.maximum(bx, 0), axis=0)
    if mode == BORDER_CONSTANT and outside.any():
        fill = np.asarray(value, np.float64).ravel()
        fill = fill[np.arange(src.shape[2]) % len(fill)] if src.ndim == 3 else fill[0]
        out[outside] = _round_u8(fill) if src.dtype == np.uint8 else np.asarray(fill).astype(
            src.dtype)
    return out


def _map_to_int(m, op):
    """A float32 map coordinate -> int64 by `op`, a value past int32 (or not
    finite) far outside any image."""
    m = np.where(np.isfinite(m), m, -2.0 ** 30)
    return op(np.clip(m, -2.0 ** 30, 2.0 ** 30)).astype(np.int64)


def remap(src, map1, map2, interpolation=INTER_LINEAR, border_mode=BORDER_CONSTANT,
          border_value=0):
    """`cv2.remap(src, map1, map2, interpolation, borderMode=border_mode,
    borderValue=border_value)` for float32 (H', W') maps: uint8 or float32
    (H, W) or (H, W, C) for INTER_LINEAR, any dtype for INTER_NEAREST."""
    src = np.asarray(src)
    mx, my = np.asarray(map1, np.float32), np.asarray(map2, np.float32)
    if interpolation == INTER_NEAREST:
        return _gather(src, _map_to_int(my, np.rint), _map_to_int(mx, np.rint), border_mode,
                       border_value)
    if interpolation != INTER_LINEAR:
        raise ValueError(f"remap interpolation {interpolation}")
    if src.dtype not in (np.uint8, np.float32):
        raise TypeError(f"remap INTER_LINEAR takes uint8 or float32, not {src.dtype}")
    ix, iy = _map_to_int(mx, np.floor), _map_to_int(my, np.floor)
    a = (mx - ix.astype(np.float32)).astype(np.float32)
    b = (my - iy.astype(np.float32)).astype(np.float32)
    if src.ndim == 3:
        a, b = a[..., None], b[..., None]
    p00, p01, p10, p11 = (_gather(src, iy + dy, ix + dx, border_mode, border_value)
                          .astype(np.float32) for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)))
    v0 = _fma32(a, p01 - p00, p00)
    v1 = _fma32(a, p11 - p10, p10)
    v = _fma32(b, v1 - v0, v0)
    return _round_u8(v) if src.dtype == np.uint8 else v


def imwrite(path, img):
    """`cv2.imwrite(path, img)` for .png (uint8 (H, W) or (H, W, 3) BGR,
    uint16 (H, W)) and .jpg / .jpeg (uint8, at cv2's default quality 95),
    written with PIL. Returns True, as cv2 does."""
    import PIL.Image

    img = np.asarray(img)
    ext = os.path.splitext(path)[1].lower()
    if img.ndim == 3 and img.shape[2] == 3:
        img = np.ascontiguousarray(img[..., ::-1])  # BGR -> RGB
    elif img.ndim != 2:
        raise ValueError(f"imwrite: shape {img.shape} not (H, W) or (H, W, 3)")
    if ext == ".png":
        if img.dtype not in (np.uint8, np.uint16) or (img.dtype == np.uint16 and img.ndim == 3):
            raise TypeError(f"imwrite .png: {img.dtype} {img.shape}")
        PIL.Image.fromarray(img).save(path)
    elif ext in (".jpg", ".jpeg"):
        if img.dtype != np.uint8:
            raise TypeError(f"imwrite {ext}: {img.dtype}")
        PIL.Image.fromarray(img).save(path, quality=JPEG_QUALITY)
    else:
        raise ValueError(f"imwrite: {ext} files are not written (.png, .jpg, .jpeg)")
    return True
