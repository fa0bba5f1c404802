"""Feature detection + description, batched on device.

SURVEY §2 lists "feature detection & matching" in the capability surface
with low-confidence recall of the reference mechanism (mount empty), so per
SURVEY §7 step 4 this is a self-contained detector + descriptor:

- Harris corner response from a smoothed structure tensor (separable
  convolutions — VPU-friendly elementwise + small matmuls),
- non-maximum suppression via ``reduce_window`` max-pooling,
- fixed-N ``top_k`` corner selection (static shapes; invalid corners are
  masked, never dropped),
- descriptors = bias/gain-normalized intensity patches, giving cosine
  similarity matching as one big matmul (match.py).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


def _gaussian_kernel(sigma: float, radius: int, dtype) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=dtype)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _sep_conv(img: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Separable 2-D convolution with reflect padding, [H, W] -> [H, W]."""
    r = (k.shape[0] - 1) // 2
    p = jnp.pad(img, ((r, r), (0, 0)), mode="reflect")
    img = jax.vmap(lambda col: jnp.convolve(col, k, mode="valid"), in_axes=1, out_axes=1)(p)
    p = jnp.pad(img, ((0, 0), (r, r)), mode="reflect")
    img = jax.vmap(lambda row: jnp.convolve(row, k, mode="valid"))(p)
    return img


def harris_response(
    img: jnp.ndarray, sigma: float = 1.5, k: float = 0.04
) -> jnp.ndarray:
    """Harris corner response, [H, W]."""
    dtype = img.dtype
    # Central-difference gradients.
    gx = 0.5 * (jnp.roll(img, -1, axis=1) - jnp.roll(img, 1, axis=1))
    gy = 0.5 * (jnp.roll(img, -1, axis=0) - jnp.roll(img, 1, axis=0))
    kern = _gaussian_kernel(sigma, int(3 * sigma), dtype)
    sxx = _sep_conv(gx * gx, kern)
    syy = _sep_conv(gy * gy, kern)
    sxy = _sep_conv(gx * gy, kern)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


class Keypoints(NamedTuple):
    xy: jnp.ndarray      # [N, 2] (x, y) pixel coordinates
    score: jnp.ndarray   # [N]
    valid: jnp.ndarray   # [N] bool


def detect_harris(
    img: jnp.ndarray,
    n_keypoints: int = 256,
    *,
    sigma: float = 1.5,
    nms_radius: int = 4,
    border: int = 8,
    rel_threshold: float = 1e-3,
) -> Keypoints:
    """Top-N Harris corners with NMS; static output shape [N]."""
    resp = harris_response(img, sigma=sigma)
    H, W = resp.shape
    # NMS: keep strict local maxima of a (2r+1)^2 window.
    pooled = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max,
        (2 * nms_radius + 1, 2 * nms_radius + 1), (1, 1), "SAME",
    )
    is_max = resp >= pooled
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    in_border = (
        (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    )
    thresh = rel_threshold * jnp.maximum(jnp.max(resp), 1e-12)
    cand = jnp.where(is_max & in_border & (resp > thresh), resp, -jnp.inf)
    score, flat_idx = jax.lax.top_k(cand.reshape(-1), n_keypoints)
    y = flat_idx // W
    x = flat_idx % W
    # Subpixel localization: 1-D quadratic fit through the response along
    # each axis (standard corner interpolation; clamped to +-0.5 px).
    def subpix(c, l, r):
        denom = l - 2.0 * c + r
        off = 0.5 * (l - r) / jnp.where(jnp.abs(denom) < 1e-12, 1.0, denom)
        return jnp.where(jnp.abs(denom) < 1e-12, 0.0, jnp.clip(off, -0.5, 0.5))

    rc = resp[y, x]
    dx = subpix(rc, resp[y, jnp.maximum(x - 1, 0)], resp[y, jnp.minimum(x + 1, W - 1)])
    dy = subpix(rc, resp[jnp.maximum(y - 1, 0), x], resp[jnp.minimum(y + 1, H - 1), x])
    xy = jnp.stack([x + dx, y + dy], axis=-1).astype(img.dtype)
    return Keypoints(xy=xy, score=score, valid=jnp.isfinite(score))


def describe_patches(
    img: jnp.ndarray, kps: Keypoints, patch_radius: int = 5
) -> jnp.ndarray:
    """Bias/gain-normalized intensity patches as descriptors.

    Patches are sampled bilinearly at the keypoint's SUBPIXEL location —
    rounding to the nearest pixel shifts the patch by up to 0.5 px, which
    decorrelates NCC on fine texture far more than detection noise does.

    [N, (2r+1)^2], unit-norm rows; cosine similarity == normalized cross
    correlation, so matching is a single [N1, D] x [D, N2] matmul.
    """
    d = 2 * patch_radius + 1
    H, W = img.shape
    offs = jnp.arange(-patch_radius, patch_radius + 1, dtype=img.dtype)

    def one(xy):
        # Sample grid centered at the exact (subpixel) keypoint.
        xs = jnp.clip(xy[0] + offs, 0.0, W - 1.001)       # [d]
        ys = jnp.clip(xy[1] + offs, 0.0, H - 1.001)
        x0 = jnp.floor(xs).astype(jnp.int32)
        y0 = jnp.floor(ys).astype(jnp.int32)
        fx = (xs - x0)[None, :]                            # [1, d]
        fy = (ys - y0)[:, None]                            # [d, 1]
        i00 = img[y0[:, None], x0[None, :]]
        i01 = img[y0[:, None], x0[None, :] + 1]
        i10 = img[y0[:, None] + 1, x0[None, :]]
        i11 = img[y0[:, None] + 1, x0[None, :] + 1]
        patch = (
            i00 * (1 - fy) * (1 - fx)
            + i01 * (1 - fy) * fx
            + i10 * fy * (1 - fx)
            + i11 * fy * fx
        )
        return patch.reshape(-1)

    patches = jax.vmap(one)(kps.xy)                       # [N, d*d]
    patches = patches - jnp.mean(patches, axis=-1, keepdims=True)
    norm = jnp.linalg.norm(patches, axis=-1, keepdims=True)
    return patches / jnp.maximum(norm, 1e-8)


def detect_and_describe(
    img: jnp.ndarray,
    n_keypoints: int = 256,
    patch_radius: int = 5,
    describe_sigma: float = 0.8,
    **kw,
) -> Tuple[Keypoints, jnp.ndarray]:
    """Detect on the raw image; describe on a lightly blurred copy
    (``describe_sigma`` > 0) so sub-pixel shifts decorrelate NCC less."""
    kps = detect_harris(img, n_keypoints, **kw)
    if describe_sigma > 0:
        k = _gaussian_kernel(describe_sigma, max(2, int(3 * describe_sigma)),
                             img.dtype)
        img = _sep_conv(img, k)
    return kps, describe_patches(img, kps, patch_radius)
