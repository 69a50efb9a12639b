"""CLAHE (contrast-limited adaptive histogram equalisation) on tensors.

The port of ``shoeprint_image_retrieval_tpu/ops/clahe.py``, in plain torch
ops, so it runs on the card when its inputs lie there. The reference
equalises every image with OpenCV's CLAHE before the CNN (reference
network.py:108-111, 197-208): gray images directly, RGB on the L channel of
cv2's LAB. Every function here is bit-exact against cv2 and against the JAX
functions of the same name:

1. the image is extended to a multiple of the tile grid with a reflect-101
   border (OpenCV's rule: an axis that divides evenly still gets a full tile
   of padding unless both axes divide);
2. one 256-bin histogram per tile, counted in int32 (``scatter_add_`` of
   integer ones: the order of the adds cannot change a count);
3. each bin clipped at ``max(1, int(clip_limit * tile_area / 256))`` and the
   excess spread as OpenCV spreads it;
4. a LUT per tile, ``round_half_even(cumsum(hist) * (255 / tile_area))`` in
   float32;
5. each pixel interpolated bilinearly between its four neighbouring tiles'
   LUTs, in float32, in the order ``(l11 * (1 - xa) + l12 * xa) * (1 - ya)
   + (l21 * (1 - xa) + l22 * xa) * ya``, rounded half to even.

Every multiply and add is its own eager op, so no multiply-add is
contracted into an FMA on either device; ``chip_smoke.py`` holds the card's
result bit-exact against the native host CLAHE.

The RGB path converts with OpenCV's 8-bit fixed-point integer algorithms
(``RGB2Lab_b`` / ``Lab2RGBinteger``), whose tables are built once in NumPy
and kept per device as int32 tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _reflect101(n_out: int, n: int, device) -> torch.Tensor:
    """Source indices of a reflect-101 extension of an axis of ``n`` pixels
    to ``n_out``, reflecting again when the pad exceeds ``n - 1`` (NumPy's
    and ``jnp.pad``'s ``"reflect"``)."""
    i = torch.arange(n_out, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i % period
    return torch.where(i < n, i, period - i)


def _fdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one correctly rounded float32 division, as
    ``jnp``'s ``num / den``. PyTorch evaluates ``float / tensor`` as
    ``tensor.reciprocal() * float``, which rounds twice and can miss the
    quotient by one bit (enough to move a LUT entry across a half)."""
    return torch.full_like(den, num) / den


def _clip_redistribute(hist: torch.Tensor, clip_limit) -> torch.Tensor:
    """OpenCV's clip and excess redistribution over the last (256-bin) axis."""
    clipped = torch.minimum(hist, torch.as_tensor(clip_limit, dtype=hist.dtype,
                                                  device=hist.device))
    excess = (hist - clipped).sum(dim=-1, keepdim=True, dtype=torch.int32)
    batch = excess // 256
    residual = excess - batch * 256  # in [0, 255]
    step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
    bins = torch.arange(256, device=hist.device, dtype=torch.int32)
    bump = (bins % step == 0) & (bins // step < residual)
    return clipped + batch + bump.to(torch.int32)


def _lut_bilinear(flat_luts, v, ty1c, ty2c, tx1c, tx2c, xa, ya, tiles_x: int) -> torch.Tensor:
    """The bilinear blend of four tile LUTs at each pixel's own value.

    ``flat_luts`` (B, tiles_y * tiles_x * 256) f32; ``v`` (B, H, W) int64;
    tile indices and weights broadcast against (B, H, W).
    """
    b = v.shape[0]

    def lut_at(tyi, txi):
        idx = (tyi * tiles_x + txi) * 256 + v
        return torch.gather(flat_luts, 1, idx.reshape(b, -1)).reshape(v.shape)

    one_xa = 1.0 - xa
    res = ((lut_at(ty1c, tx1c) * one_xa + lut_at(ty1c, tx2c) * xa) * (1.0 - ya)
           + (lut_at(ty2c, tx1c) * one_xa + lut_at(ty2c, tx2c) * xa) * ya)
    return torch.clamp(torch.round(res), 0, 255)


def _tile_coords(n: int, inv_tile: torch.Tensor, tiles: int, device):
    """Per-pixel (t1 clamped, t2 clamped, fractional weight) along one axis:
    ``tf = i * (1 / tile) - 0.5`` in float32."""
    tf = torch.arange(n, device=device, dtype=torch.float32) * inv_tile - 0.5
    t1 = torch.floor(tf).to(torch.int64)
    frac = tf - t1.to(torch.float32)
    return t1.clamp(0, tiles - 1), (t1 + 1).clamp(0, tiles - 1), frac


def clahe_u8(img: torch.Tensor, clip_limit: float = 2.0,
             tile_grid_size: tuple[int, int] = (8, 8)) -> torch.Tensor:
    """CLAHE for a (H, W) or (B, H, W) uint8 tensor (cv2's ``apply``)."""
    squeeze = img.ndim == 2
    x = img[None] if squeeze else img
    tiles_x, tiles_y = tile_grid_size  # cv2 takes (width, height)
    b, h, w = x.shape
    dev = x.device
    if h % tiles_y == 0 and w % tiles_x == 0:
        eh, ew = h, w
    else:
        eh, ew = h + tiles_y - h % tiles_y, w + tiles_x - w % tiles_x
    ext = x[:, _reflect101(eh, h, dev)][:, :, _reflect101(ew, w, dev)]
    th, tw = eh // tiles_y, ew // tiles_x
    tile_area = th * tw
    clip = max(int(clip_limit * tile_area / 256.0), 1)

    ys = torch.arange(eh, device=dev) // th
    xs = torch.arange(ew, device=dev) // tw
    seg = (ys[:, None] * tiles_x + xs[None, :]) * 256 + ext.to(torch.int64)
    n_seg = tiles_y * tiles_x * 256
    hist = torch.zeros((b, n_seg), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, seg.reshape(b, -1), torch.ones_like(seg.reshape(b, -1), dtype=torch.int32))
    hist = _clip_redistribute(hist.reshape(b, tiles_y, tiles_x, 256), clip)
    scale = torch.tensor(255.0 / tile_area, dtype=torch.float32, device=dev)
    luts = torch.clamp(torch.round(torch.cumsum(hist, dim=-1).to(torch.float32) * scale), 0, 255)

    tx1c, tx2c, xa = _tile_coords(w, torch.tensor(1.0 / tw, dtype=torch.float32, device=dev),
                                  tiles_x, dev)
    ty1c, ty2c, ya = _tile_coords(h, torch.tensor(1.0 / th, dtype=torch.float32, device=dev),
                                  tiles_y, dev)
    out = _lut_bilinear(luts.reshape(b, -1), x.to(torch.int64), ty1c[:, None], ty2c[:, None],
                        tx1c[None, :], tx2c[None, :], xa[None, :], ya[:, None], tiles_x)
    out = out.to(torch.uint8)
    return out[0] if squeeze else out


def clahe_batched_dynamic(imgs: torch.Tensor, valid_hw: torch.Tensor, clip_limit: float = 2.0,
                          tile_grid_size: tuple[int, int] = (8, 8)) -> torch.Tensor:
    """CLAHE over a padded (B, Hc, Wc) uint8 batch with per-sample sizes.

    Each sample's tile geometry, clip limit and LUT scale come from its own
    ``valid_hw`` (B, 2) row, so one call serves a canvas of mixed sizes; the
    result equals :func:`clahe_u8` on each native-size image, with zeros
    outside each valid region. Where an image is smaller than the tile grid
    the reflect-101 extension clamps (as the native host CLAHE does) instead
    of reflecting again as cv2 does.
    """
    tiles_x, tiles_y = tile_grid_size
    b, hc, wc = imgs.shape
    dev = imgs.device
    he, we = hc + tiles_y, wc + tiles_x  # extended canvas upper bound
    vh = valid_hw[:, 0].to(torch.int64)
    vw = valid_hw[:, 1].to(torch.int64)
    divisible = (vh % tiles_y == 0) & (vw % tiles_x == 0)
    eh = vh + torch.where(divisible, 0, tiles_y - vh % tiles_y)
    ew = vw + torch.where(divisible, 0, tiles_x - vw % tiles_x)
    th = (eh // tiles_y)[:, None, None]
    tw = (ew // tiles_x)[:, None, None]
    area = (th * tw).to(torch.float32)
    clip = torch.clamp(torch.floor(clip_limit * area / 256.0).to(torch.int32), min=1)

    h, w = vh[:, None, None], vw[:, None, None]
    ys = torch.arange(he, device=dev)[None, :, None]
    xs = torch.arange(we, device=dev)[None, None, :]
    ry = torch.where(ys < h, ys, 2 * (h - 1) - ys).clamp(0, hc - 1)
    rx = torch.where(xs < w, xs, 2 * (w - 1) - xs).clamp(0, wc - 1)
    rows = torch.gather(imgs, 1, ry.expand(b, he, wc))
    ext = torch.gather(rows, 2, rx.expand(b, he, we))

    ty = torch.minimum(ys // th, torch.tensor(tiles_y - 1, device=dev))
    tx = torch.minimum(xs // tw, torch.tensor(tiles_x - 1, device=dev))
    in_ext = (ys < eh[:, None, None]) & (xs < ew[:, None, None])
    n_seg = tiles_y * tiles_x * 256
    seg = torch.where(in_ext, (ty * tiles_x + tx) * 256 + ext.to(torch.int64), n_seg)
    hist = torch.zeros((b, n_seg + 1), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, seg.reshape(b, -1), torch.ones((b, he * we), dtype=torch.int32, device=dev))
    hist = _clip_redistribute(hist[:, :n_seg].reshape(b, tiles_y, tiles_x, 256), clip[..., None])
    scale = _fdiv(255.0, area)[..., None]  # (B, 1, 1, 1) f32
    luts = torch.clamp(torch.round(torch.cumsum(hist, dim=-1).to(torch.float32) * scale), 0, 255)

    yy = torch.arange(hc, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(wc, device=dev, dtype=torch.float32)[None, None, :]
    tyf = yy * _fdiv(1.0, th.to(torch.float32)) - 0.5
    txf = xx * _fdiv(1.0, tw.to(torch.float32)) - 0.5
    ty1 = torch.floor(tyf).to(torch.int64)
    tx1 = torch.floor(txf).to(torch.int64)
    ya = tyf - ty1.to(torch.float32)
    xa = txf - tx1.to(torch.float32)
    out = _lut_bilinear(luts.reshape(b, -1), imgs.to(torch.int64),
                        ty1.clamp(0, tiles_y - 1), (ty1 + 1).clamp(0, tiles_y - 1),
                        tx1.clamp(0, tiles_x - 1), (tx1 + 1).clamp(0, tiles_x - 1),
                        xa, ya, tiles_x)
    in_valid = (yy < h) & (xx < w)
    return torch.where(in_valid, out, 0.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# RGB <-> LAB, bit-exact against OpenCV's 8-bit fixed-point conversions
# (color_lab.cpp RGB2Lab_b / Lab2RGBinteger): the JAX package's tables, built
# with the same NumPy arithmetic, then applied with int32 tensor ops.
# ---------------------------------------------------------------------------

_LAB_SHIFT = 12          # xyz fixed-point shift
_GAMMA_SHIFT = 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_LAB_BASE = 1 << 14      # Lab2RGBinteger BASE
_LAB_MIN_AB = -8145      # abToXZ table origin
_INV_GAMMA_SIZE = 1 << 12
_D65 = (0.950456, 1.0, 1.088754)
_SRGB2XYZ = (0.412453, 0.357580, 0.180423,
             0.212671, 0.715160, 0.072169,
             0.019334, 0.119193, 0.950227)
_XYZ2SRGB = (3.240479, -1.537150, -0.498535,
             -0.969256, 1.875992, 0.041556,
             0.055648, -0.204043, 1.057311)


def _cvround(x):
    """cvRound: round half to even (``np.rint``), as int64."""
    return np.rint(x).astype(np.int64)


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


@functools.cache
def _rgb2lab_tables():
    """OpenCV RGB2Lab_b tables: sRGB gamma (x8 fixed point), cbrt, coeffs.

    Entries 49 and 628 of the cbrt table are nudged to match cv2's softfloat
    table generation (f64 rounding lands on the other side of the half).
    """
    i = np.arange(256) / 255.0
    g = np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)
    gamma_tab = _cvround(255 * (1 << _GAMMA_SHIFT) * g)

    n = 256 * 3 // 2 * (1 << _GAMMA_SHIFT)
    xi = np.arange(n, dtype=np.float64) / (255.0 * (1 << _GAMMA_SHIFT))
    f = np.where(xi < 216.0 / 24389.0, xi * (841.0 / 108.0) + 16.0 / 116.0, np.cbrt(xi))
    cbrt_tab = _cvround((1 << _LAB_SHIFT2) * f)
    cbrt_tab[49] -= 1
    cbrt_tab[628] += 1

    coeffs = np.array([_cvround(np.float64(1 << _LAB_SHIFT) * _SRGB2XYZ[r * 3 + c] / _D65[r])
                       for r in range(3) for c in range(3)])
    return gamma_tab, cbrt_tab, coeffs


@functools.cache
def _lab2rgb_tables():
    """OpenCV Lab2RGBinteger tables: L -> (y, ify), ab -> xz, coeffs, inverse gamma."""
    base = _LAB_BASE
    y_tab = np.zeros(256, np.int64)
    ify_tab = np.zeros(256, np.int64)
    for i in range(256):
        if i <= 20:  # L*100/255 <= 8: the CIE linear region
            y_tab[i] = round(i * base * 100 / 903.3 / 255)
            ify_tab[i] = round(base * (7.787 * (i * 100 / 903.3 / 255) + 16 / 116))
        else:
            fy = (i * 100 / 255 + 16) / 116
            ify_tab[i] = round(base * fy)
            y_tab[i] = round(base * fy**3)

    n_t = base * 9 // 4
    idx = np.arange(_LAB_MIN_AB, _LAB_MIN_AB + n_t, dtype=np.int64)

    def cdiv(a, b):  # C integer division (truncates toward zero)
        q = np.abs(a) // b
        return np.where(a < 0, -q, q)

    lin = cdiv(idx * 108, 841) - ((base * 16 // 116) * 108 // 841)
    cube = cdiv(cdiv(idx * idx, base) * idx, base)
    ab_tab = np.where(idx <= 3390, lin, cube)  # 3390 ~ BASE*6/29

    coeffs = np.array([_cvround(np.float64(1 << _LAB_SHIFT) * _XYZ2SRGB[r * 3 + c] * _D65[c])
                       for r in range(3) for c in range(3)])
    u = np.arange(_INV_GAMMA_SIZE, dtype=np.float64) / _INV_GAMMA_SIZE
    ginv = np.where(u <= 0.0031308, 12.92 * u, 1.055 * np.maximum(u, 0) ** (1 / 2.4) - 0.055)
    inv_gamma_tab = np.clip(_cvround(255.0 * ginv), 0, 255)
    return y_tab, ify_tab, ab_tab, coeffs, inv_gamma_tab


@functools.cache
def _device_tables(device: torch.device):
    """Both directions' tables as int32 tensors on ``device``, made once."""
    gamma_tab, cbrt_tab, fwd = _rgb2lab_tables()
    y_tab, ify_tab, ab_tab, inv, inv_gamma_tab = _lab2rgb_tables()
    t = {name: torch.as_tensor(a.astype(np.int32), device=device)
         for name, a in (("gamma", gamma_tab), ("cbrt", cbrt_tab), ("y", y_tab),
                         ("ify", ify_tab), ("ab", ab_tab), ("inv_gamma", inv_gamma_tab))}
    return t, [int(v) for v in fwd], [int(v) for v in inv]


def rgb_to_lab_u8(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> LAB exactly as ``cv2.cvtColor(..., COLOR_RGB2LAB)``.

    OpenCV's RGB2Lab_b: gamma-expand through a 256-entry x2040 table, XYZ at
    2^12 fixed point (coefficients folded with the D65 white point), f(t)
    through a 3072-entry cbrt table at 2^15, then L/a/b by integer descale.
    int32 throughout (products fit: 2040 * 4433 * 3).
    """
    t, c, _ = _device_tables(rgb.device)
    idx = rgb.to(torch.int64)
    r, g, b = (t["gamma"][idx[..., k]] for k in range(3))
    fx = t["cbrt"][_descale(r * c[0] + g * c[1] + b * c[2], _LAB_SHIFT).to(torch.int64)]
    fy = t["cbrt"][_descale(r * c[3] + g * c[4] + b * c[5], _LAB_SHIFT).to(torch.int64)]
    fz = t["cbrt"][_descale(r * c[6] + g * c[7] + b * c[8], _LAB_SHIFT).to(torch.int64)]
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    l_val = _descale(l_scale * fy + l_shift, _LAB_SHIFT2)
    a_val = _descale(500 * (fx - fy) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    b_val = _descale(200 * (fy - fz) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    return torch.stack([l_val, a_val, b_val], dim=-1).clamp(0, 255).to(torch.uint8)


def lab_u8_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 LAB -> RGB exactly as ``cv2.cvtColor(..., COLOR_LAB2RGB)``.

    OpenCV's Lab2RGBinteger: L through a 256-entry (y, ify) table at 2^14,
    a/b folded into ifx/ifz by fixed-point multiplies, x/z through the
    integer-division abToXZ table, a 3x3 integer matrix (coefficients folded
    with D65) descaled into a 4096-entry inverse sRGB gamma table. int32
    suffices: |coeff * xyz| < 2^27.
    """
    t, _, c = _device_tables(lab.device)
    base = _LAB_BASE
    n_t = base * 9 // 4
    li = lab[..., 0].to(torch.int64)
    ai = lab[..., 1].to(torch.int32)
    bi = lab[..., 2].to(torch.int32)
    y = t["y"][li]
    ify = t["ify"][li]
    adiv = ((5 * ai * 53687 + (1 << 7)) >> 13) - 128 * base // 500
    bdiv = ((bi * 41943 + (1 << 4)) >> 9) - (128 * base // 200) + 1
    x = t["ab"][(ify + adiv - _LAB_MIN_AB).clamp(0, n_t - 1).to(torch.int64)]
    z = t["ab"][(ify - bdiv - _LAB_MIN_AB).clamp(0, n_t - 1).to(torch.int64)]
    shift = _LAB_SHIFT + 2  # descale from 2^26 to the 4096-entry gamma domain
    out = []
    for r in range(3):
        o = _descale(c[3 * r] * x + c[3 * r + 1] * y + c[3 * r + 2] * z, shift)
        out.append(t["inv_gamma"][o.clamp(0, _INV_GAMMA_SIZE - 1).to(torch.int64)])
    return torch.stack(out, dim=-1).to(torch.uint8)


def clahe_image(img: torch.Tensor, clip_limit: float = 2.0,
                tile_grid_size: tuple[int, int] = (8, 8)) -> torch.Tensor:
    """The reference's ``_clahe`` (network.py:197-208): gray directly, RGB
    on the LAB L channel."""
    if img.ndim == 2 or img.shape[-1] != 3:
        return clahe_u8(img, clip_limit, tile_grid_size)
    lab = rgb_to_lab_u8(img)
    l_eq = clahe_u8(lab[..., 0], clip_limit, tile_grid_size)
    return lab_u8_to_rgb(torch.cat([l_eq[..., None], lab[..., 1:]], dim=-1))
