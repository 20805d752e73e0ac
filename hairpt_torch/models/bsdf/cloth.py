"""Irawan & Marschner woven-cloth BRDF (port of
hairpt/models/bsdf/cloth.py).

The reference's src/bsdfs/irawan.{h,cpp} (Piti Irawan's thesis model):
an explicit weave pattern (a tile of warp and weft yarn segments) drives
a spatially varying specular yarn highlight (the filament or the staple
integrand) plus a per-yarn diffuse term. The uv-dependent yarn
resolution runs at material-gather time (cloth_resolve, called from
registry.gather on the cloth lanes), so the BSDF evaluation is a
branchless function of per-lane scalars; the weave DSL parser and the
Monte Carlo specular normalization (irawan.cpp:147-171) run at scene
build, the parser on the host, the normalization on the build device
from the JAX package's numpy samples.

GatheredMat field mapping for CLOTH lanes (set by registry.gather):
  diffuse    <- yarn kd
  specular   <- yarn ks * specNorm * intensityVariation * areaScale
  exponent   <- u   (yarn inclination coordinate)
  alpha      <- v   (yarn azimuth coordinate)
  beta_r     <- umax (after the correlated-noise adjustment)
  scale_tilt <- psi
  eta        <- kappa
  sigma_a    <- (width, length, is_weft)
Per-pattern scalars ride the material row: transmit = (alpha, beta, ss),
k = (hWidth, 0, 0).
"""
from __future__ import annotations

import math
import re
from typing import NamedTuple

import numpy as np
import torch

from ... import resolve_device
from ...core import noise
from . import registry as R

CLOTH_KIND = R.CLOTH
TEA_ROUNDS = 8   # irawan.cpp:262 teaIterations


class ClothTable(NamedTuple):
    """[P] weave patterns, padded to common tile and yarn-count sizes."""
    pattern: torch.Tensor     # [P, TH, TW] int32 yarn index (0-based)
    tile_w: torch.Tensor      # [P] float32
    tile_h: torch.Tensor      # [P]
    repeat_u: torch.Tensor    # [P]
    repeat_v: torch.Tensor    # [P]
    period: torch.Tensor      # [P]
    fineness: torch.Tensor    # [P]
    d_umax: torch.Tensor      # [P, 4] dWarp/dWarp, dWarp/dWeft,
    #                           dWeft/dWarp, dWeft/dWeft (radians)
    spec_norm: torch.Tensor   # [P] MC specular normalization
    yarn_type: torch.Tensor   # [P, Y] 0 = warp, 1 = weft
    yarn_psi: torch.Tensor    # [P, Y] radians
    yarn_umax: torch.Tensor   # [P, Y] radians
    yarn_kappa: torch.Tensor  # [P, Y]
    yarn_w: torch.Tensor      # [P, Y]
    yarn_l: torch.Tensor      # [P, Y]
    yarn_cu: torch.Tensor     # [P, Y] centerU
    yarn_cv: torch.Tensor     # [P, Y] centerV
    yarn_kd: torch.Tensor     # [P, Y, 3]
    yarn_ks: torch.Tensor     # [P, Y, 3]
    area_scale: torch.Tensor  # [P, 2] (warp+weft)/warp, (warp+weft)/weft


# ---------------------------------------------------------------------------
# host-side weave pattern description and DSL parser (irawan.h grammar)
# ---------------------------------------------------------------------------

class WeavePattern:
    """Plain-python weave description (irawan.h WeavePattern + Yarn)."""

    def __init__(self):
        self.name = ""
        self.alpha = 0.0
        self.beta = 0.0
        self.ss = 0.0
        self.h_width = 0.0
        self.warp_area = 1.0
        self.weft_area = 1.0
        self.tile_width = 0
        self.tile_height = 0
        self.d_warp_umax_over_d_warp = 0.0
        self.d_warp_umax_over_d_weft = 0.0
        self.d_weft_umax_over_d_warp = 0.0
        self.d_weft_umax_over_d_weft = 0.0
        self.fineness = 0.0
        self.period = 0.0
        self.pattern = []       # 1-based yarn ids, row-major [th, tw]
        self.yarns = []         # list of dicts


_YARN_DEFAULTS = dict(type=0, psi=0.0, umax=0.0, kappa=0.0, width=0.0,
                      length=0.0, centerU=0.0, centerV=0.0,
                      kd=(0.0, 0.0, 0.0), ks=(0.0, 0.0, 0.0))
_DEG_KEYS = {"psi", "umax", "dWarpUmaxOverDWarp", "dWarpUmaxOverDWeft",
             "dWeftUmaxOverDWarp", "dWeftUmaxOverDWeft"}
_KEY_MAP = {"tileWidth": "tile_width", "tileHeight": "tile_height",
            "hWidth": "h_width", "warpArea": "warp_area",
            "weftArea": "weft_area",
            "dWarpUmaxOverDWarp": "d_warp_umax_over_d_warp",
            "dWarpUmaxOverDWeft": "d_warp_umax_over_d_weft",
            "dWeftUmaxOverDWarp": "d_weft_umax_over_d_warp",
            "dWeftUmaxOverDWeft": "d_weft_umax_over_d_weft"}


def _parse_value(txt, props):
    txt = txt.strip()
    if txt.startswith("$"):
        return props[txt[1:]]
    if txt.startswith("{"):
        return tuple(float(x) for x in txt.strip("{}").split(","))
    if txt.startswith('"'):
        return txt.strip('"')
    if txt in ("warp", "weft"):
        return 0 if txt == "warp" else 1
    return float(txt)


def parse_weave(text: str, props=None) -> WeavePattern:
    """Parse the irawan weave DSL (irawan.h WeavePatternGrammar): a
    `weave { key = value, ..., pattern {...}, yarn {...}, ... }` block
    with /* */ comments and $var substitution from `props`."""
    props = props or {}
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    m = re.search(r"weave\s*\{(.*)\}\s*$", text, flags=re.S)
    if not m:
        raise ValueError("not a weave pattern file")
    body = m.group(1)
    wp = WeavePattern()

    def yarn_sub(mo):
        yarn = dict(_YARN_DEFAULTS)
        for key, val in re.findall(
                r"(\w+)\s*=\s*(\{[^}]*\}|\$\w+|\"[^\"]*\"|[-\w.+eE]+)",
                mo.group(1)):
            v = _parse_value(val, props)
            if key in _DEG_KEYS:
                v = float(v) * np.pi / 180.0
            yarn[key] = v
        wp.yarns.append(yarn)
        return " "

    def pattern_sub(mo):
        wp.pattern = [int(x) for x in re.findall(r"\d+", mo.group(1))]
        return " "

    # yarn bodies contain one level of nested {r, g, b} braces
    body = re.sub(r"yarn\s*\{((?:[^{}]|\{[^{}]*\})*)\}", yarn_sub, body)
    body = re.sub(r"pattern\s*\{([^}]*)\}", pattern_sub, body)
    for key, val in re.findall(
            r"(\w+)\s*=\s*(\$\w+|\"[^\"]*\"|[-\w.+eE]+)", body):
        v = _parse_value(val, props)
        if key in _DEG_KEYS:
            v = float(v) * np.pi / 180.0
        attr = _KEY_MAP.get(key, key)
        if attr in ("tile_width", "tile_height"):
            v = int(v)
        setattr(wp, attr, v)
    if len(wp.pattern) != wp.tile_width * wp.tile_height:
        raise ValueError("pattern size != tileWidth*tileHeight")
    if not all(0 < pid <= len(wp.yarns) for pid in wp.pattern):
        raise ValueError("pattern references missing yarn")
    return wp


# generic built-in weaves (plain / tabby and a 2/2 twill), the JAX
# package's: yarn geometry follows the model's constraints
# (w sin(umax) < l), colours are placeholders meant to be overridden via
# $warp_kd etc.
BUILTIN_WEAVES = {
    "plain": """
weave {
  name = "plain weave",
  tileWidth = 2, tileHeight = 2,
  alpha = 0.3, beta = 6.0, ss = 0.0, hWidth = 0.5,
  warpArea = 1.0, weftArea = 1.0,
  fineness = 0.0, period = 0.0,
  pattern { 1, 2, 2, 1 },
  yarn { type = warp, psi = 30, umax = 55, kappa = -0.5,
         width = 1.0, length = 2.2, centerU = 0.5, centerV = 0.5,
         kd = {0.35, 0.33, 0.3}, ks = {0.4, 0.4, 0.4} },
  yarn { type = weft, psi = 30, umax = 55, kappa = -0.5,
         width = 1.0, length = 2.2, centerU = 0.5, centerV = 0.5,
         kd = {0.35, 0.33, 0.3}, ks = {0.4, 0.4, 0.4} }
}
""",
    "twill": """
weave {
  name = "2/2 twill",
  tileWidth = 4, tileHeight = 4,
  alpha = 0.15, beta = 8.0, ss = 0.2, hWidth = 0.5,
  warpArea = 2.0, weftArea = 1.0,
  fineness = 0.0, period = 0.0,
  pattern { 1, 1, 2, 2,  2, 1, 1, 2,  2, 2, 1, 1,  1, 2, 2, 1 },
  yarn { type = warp, psi = 0, umax = 40, kappa = 0.0,
         width = 1.2, length = 3.5, centerU = 0.5, centerV = 0.5,
         kd = {0.1, 0.12, 0.35}, ks = {0.5, 0.5, 0.55} },
  yarn { type = weft, psi = 0, umax = 40, kappa = 0.0,
         width = 1.2, length = 3.5, centerU = 0.5, centerV = 0.5,
         kd = {0.6, 0.6, 0.62}, ks = {0.5, 0.5, 0.5} }
}
""",
}


def pack_cloth(patterns, repeat_uv, device=None) -> ClothTable:
    """Pack WeavePatterns (and each one's (repeatU, repeatV)) into a
    padded ClothTable on `device` (the card unless "cpu"), with the
    Monte Carlo specular normalization (irawan.cpp configure(): 10,000
    cosine-sampled wi / wo and uniform uv per pattern, drawn on the host
    from the JAX package's numpy stream, evaluated on `device`;
    norm = N / (sum of the un-normalized specular eval) / pi)."""
    dev = resolve_device(device)
    P = len(patterns)
    TH = max(p.tile_height for p in patterns)
    TW = max(p.tile_width for p in patterns)
    Y = max(len(p.yarns) for p in patterns)
    pat = np.zeros((P, TH, TW), np.int32)
    ys = {k: np.zeros((P, Y), np.float32)
          for k in ("type", "psi", "umax", "kappa", "width", "length",
                    "centerU", "centerV")}
    kd = np.zeros((P, Y, 3), np.float32)
    ks = np.zeros((P, Y, 3), np.float32)
    scal = {k: np.zeros((P,), np.float32)
            for k in ("tile_w", "tile_h", "repeat_u", "repeat_v", "period",
                      "fineness")}
    d4 = np.zeros((P, 4), np.float32)
    area = np.ones((P, 2), np.float32)
    for i, (p, (ru, rv)) in enumerate(zip(patterns, repeat_uv)):
        a = np.asarray(p.pattern, np.int32).reshape(p.tile_height,
                                                    p.tile_width) - 1
        pat[i, :p.tile_height, :p.tile_width] = a
        for j, yarn in enumerate(p.yarns):
            for k in ys:
                ys[k][i, j] = float(yarn[k] if not isinstance(yarn[k], tuple)
                                    else yarn[k][0])
            kd[i, j] = yarn["kd"]
            ks[i, j] = yarn["ks"]
        scal["tile_w"][i] = p.tile_width
        scal["tile_h"][i] = p.tile_height
        scal["repeat_u"][i] = ru
        scal["repeat_v"][i] = rv
        scal["period"][i] = p.period
        scal["fineness"][i] = p.fineness
        d4[i] = (p.d_warp_umax_over_d_warp, p.d_warp_umax_over_d_weft,
                 p.d_weft_umax_over_d_warp, p.d_weft_umax_over_d_weft)
        total = p.warp_area + p.weft_area
        area[i] = (total / max(p.warp_area, 1e-6),
                   total / max(p.weft_area, 1e-6))

    def t(a):
        return torch.as_tensor(a, device=dev)
    ct = ClothTable(
        pattern=t(pat), tile_w=t(scal["tile_w"]), tile_h=t(scal["tile_h"]),
        repeat_u=t(scal["repeat_u"]), repeat_v=t(scal["repeat_v"]),
        period=t(scal["period"]), fineness=t(scal["fineness"]),
        d_umax=t(d4), spec_norm=t(np.ones((P,), np.float32)),
        yarn_type=t(ys["type"]), yarn_psi=t(ys["psi"]),
        yarn_umax=t(ys["umax"]), yarn_kappa=t(ys["kappa"]),
        yarn_w=t(ys["width"]), yarn_l=t(ys["length"]),
        yarn_cu=t(ys["centerU"]), yarn_cv=t(ys["centerV"]), yarn_kd=t(kd),
        yarn_ks=t(ks), area_scale=t(area))
    norms = np.ones((P,), np.float32)
    rs = np.random.RandomState(7)
    n_s = 10000
    for i, p in enumerate(patterns):
        wi = t(_cosine_dirs(rs, n_s))
        wo = t(_cosine_dirs(rs, n_s))
        uv = t(rs.rand(n_s, 2).astype(np.float32))
        pid = torch.full((n_s,), i, dtype=torch.int64, device=dev)
        scal4 = t(np.asarray([p.alpha, p.beta, p.ss, p.h_width],
                             np.float32)).expand(n_s, 4)
        res = cloth_resolve(ct, pid, uv, init=True)
        spec = _integrand(res, wi, wo, scal4[..., 0], scal4[..., 1],
                          scal4[..., 2], scal4[..., 3])
        # spec includes the trailing cosTheta(wo); configure() divides it
        # back out (irawan.cpp:161); gain = intensityVariation * areaScale
        spec = spec / torch.clamp(wo[..., 2], min=1e-6)
        total = float(torch.sum(spec * res["gain"]))
        norms[i] = n_s / (total * np.pi) if total > 0 else 0.0
    return ct._replace(spec_norm=t(norms))


def _cosine_dirs(rs, n):
    u1 = rs.rand(n)
    u2 = rs.rand(n)
    r = np.sqrt(u1)
    phi = 2 * np.pi * u2
    return np.stack([r * np.cos(phi), r * np.sin(phi),
                     np.sqrt(np.maximum(1 - u1, 0))], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# gather-time yarn resolution (uv -> per-lane yarn scalars)
# ---------------------------------------------------------------------------

def cloth_resolve(ct: ClothTable, pid, uv, init=False):
    """Resolve the weave at uv (irawan.cpp eval():188-280, its texturing
    stage). pid [N] pattern ids, uv [N, 2]. Returns a per-lane dict. The
    float -> u32 casts of the noise's cell positions follow XLA's
    saturating rule (noise.float_to_u32), as the JAX package's do: a uv
    outside [0, 1] gives negative positions, which cast to 0."""
    pid = pid.long()
    tw = ct.tile_w[pid]
    th = ct.tile_h[pid]
    x = uv[..., 0] * ct.repeat_u[pid] * tw
    y = (1.0 - uv[..., 1]) * ct.repeat_v[pid] * th
    ix = torch.floor(x).to(torch.int32)
    iy = torch.floor(y).to(torch.int32)
    lx = torch.remainder(ix, tw.to(torch.int32))
    ly = torch.remainder(iy, th.to(torch.int32))
    yid = ct.pattern[pid, ly.long(), lx.long()].long()     # [N]

    cu = ct.yarn_cu[pid, yid]
    cv = ct.yarn_cv[pid, yid]
    # tile-cell corner of the current tile and the yarn centre inside it
    cx = torch.floor(ix.to(x.dtype) / tw) * tw + cu * tw
    cy = torch.floor(iy.to(x.dtype) / th) * th + (1.0 - cv) * th
    dx = x - cx
    dy = -(y - cy)

    is_weft = ct.yarn_type[pid, yid] > 0.5            # 0 warp / 1 weft
    # weft: rotate local xy by pi/2 about z (the directions rotate in eval)
    dx, dy = torch.where(is_weft, -dy, dx), torch.where(is_weft, dx, dy)

    umax = ct.yarn_umax[pid, yid]
    psi = ct.yarn_psi[pid, yid]
    kappa = ct.yarn_kappa[pid, yid]
    w = ct.yarn_w[pid, yid]
    length = ct.yarn_l[pid, yid]

    # correlated noise on umax (irawan.cpp:264-276)
    period = ct.period[pid]
    pos_x = noise.float_to_u32(cx)
    pos_y = noise.float_to_u32(cy)
    tea1 = noise.sample_tea_float(pos_x, (2 * pos_y) & noise.M32,
                                  TEA_ROUNDS).to(x.dtype)
    tea2 = noise.sample_tea_float(pos_x, (2 * pos_y + 1) & noise.M32,
                                  TEA_ROUNDS).to(x.dtype)
    safe_p = torch.clamp(period, min=1e-6)
    zero = torch.zeros_like(cx)
    n1 = noise.perlin(torch.stack(
        [(cx * (th * ct.repeat_v[pid] + tea1) + cy) / safe_p, zero, zero],
        -1))
    n2 = noise.perlin(torch.stack(
        [(cy * (tw * ct.repeat_u[pid] + tea2) + cx) / safe_p, zero, zero],
        -1))
    d_w = torch.where(is_weft, ct.d_umax[pid, 2], ct.d_umax[pid, 0])
    d_f = torch.where(is_weft, ct.d_umax[pid, 3], ct.d_umax[pid, 1])
    umax = torch.where(period > 0.0, umax + n1 * d_w + n2 * d_f, umax)

    u = dy / (length * 0.5) * umax
    v = dx * math.pi / torch.clamp(w, min=1e-9)

    # random intensity variation (irawan.cpp:292-303)
    fineness = ct.fineness[pid]
    i1 = noise.float_to_u32((cx + dx) * fineness)
    i2 = noise.float_to_u32((cy + dy) * fineness)
    xi = noise.sample_tea_float(i1, i2, TEA_ROUNDS).to(x.dtype)
    iv = torch.clamp(-torch.log(torch.clamp(xi, min=1e-10)), max=10.0)
    iv = torch.where(fineness > 0.0, iv, 1.0)

    a_scale = torch.where(is_weft, ct.area_scale[pid, 1],
                          ct.area_scale[pid, 0])
    gain = iv * a_scale
    out = dict(u=u, v=v, umax=umax, psi=psi, kappa=kappa, w=w, l=length,
               is_weft=is_weft)
    if init:
        return dict(out, gain=gain)
    ks = ct.yarn_ks[pid, yid] * (gain * ct.spec_norm[pid])[..., None]
    return dict(out, kd=ct.yarn_kd[pid, yid], ks=ks)


# ---------------------------------------------------------------------------
# the scattering integrands (irawan.cpp:383-549), branchless
# ---------------------------------------------------------------------------

def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _normalize(a):
    return a / torch.clamp(torch.sqrt(_dot(a, a)), min=1e-12)[..., None]


def _von_mises(cos_x, b):
    """irawan.cpp vonMises: exp(b cos x) / (2 pi I0(b)) with the
    Abramowitz-Stegun polynomial I0."""
    ab = torch.abs(b)
    t = ab / 3.75
    t2 = t * t
    i0_small = 1.0 + t2 * (3.5156229 + t2 * (3.0899424 + t2 * (1.2067492
               + t2 * (0.2659732 + t2 * (0.0360768 + t2 * 0.0045813)))))
    ti = 3.75 / torch.clamp(ab, min=1e-9)
    i0_large = torch.exp(ab) / torch.sqrt(torch.clamp(ab, min=1e-9)) \
        * (0.39894228 + ti * (0.01328592 + ti * (0.00225319
           + ti * (-0.00157565 + ti * (0.00916281 + ti * (-0.02057706
           + ti * (0.02635537 + ti * (-0.01647633 + ti * 0.00392377))))))))
    i0 = torch.where(ab <= 3.75, i0_small, i0_large)
    return torch.exp(b * cos_x) / (2.0 * math.pi * i0)


def _seeliger(c1, c2):
    """irawan.cpp seeliger with sg_a = 0, sg_s = 1 (albedo 1)."""
    c1 = torch.clamp(c1, min=0.0)
    c2 = torch.clamp(c2, min=0.0)
    s = c1 + c2
    return torch.where((c1 > 0) & (c2 > 0),
                       c1 * c2 / (4.0 * math.pi * torch.clamp(s, min=1e-12)),
                       0.0)


def _atanh(x):
    xc = torch.clamp(x, -1.0 + 1e-6, 1.0 - 1e-6)
    return 0.5 * torch.log((1.0 + xc) / (1.0 - xc))


def _radius_of_curvature(u, umax, kappa, w, length):
    """irawan.cpp radiusOfCurvature: the yarn spine is an ellipse,
    parabola or hyperbola segment selected by rhat (thesis 5.3)."""
    tan_umax = torch.tan(torch.clamp(umax, min=1e-6))
    rhat = 1.0 + kappa * (1.0 + 1.0 / tan_umax)
    a = 0.5 * w
    sin_umax = torch.sin(umax)
    rest = 0.5 * length - a * sin_umax

    r_circle = rest / torch.clamp(sin_umax, min=1e-9)

    # ellipse (rhat > 0)
    rh_pos = torch.clamp(rhat, min=1e-9)
    tmax_e = torch.atan(rh_pos * tan_umax)
    bhat_e = rest / torch.clamp(torch.sin(tmax_e), min=1e-9)
    ahat_e = bhat_e / rh_pos
    t_e = torch.atan(rh_pos * torch.tan(u))
    r_ell = (bhat_e ** 2 * torch.cos(t_e) ** 2
             + ahat_e ** 2 * torch.sin(t_e) ** 2) ** 1.5 \
        / torch.clamp(ahat_e * bhat_e, min=1e-12)

    # hyperbola (rhat < 0)
    rh_neg = torch.clamp(rhat, max=-1e-9)
    tmax_h = -_atanh(rh_neg * tan_umax)
    bhat_h = rest / torch.clamp(torch.sinh(torch.abs(tmax_h)), min=1e-9) \
        * torch.sign(tmax_h + 1e-30)
    ahat_h = bhat_h / rh_neg
    t_h = -_atanh(rh_neg * torch.tan(u))
    ab_h = ahat_h * bhat_h
    r_hyp = -(bhat_h ** 2 * torch.cosh(t_h) ** 2
              + ahat_h ** 2 * torch.sinh(t_h) ** 2) ** 1.5 \
        / torch.where(torch.abs(ab_h) > 1e-12, ab_h, 1e-12)

    # parabola (rhat == 0)
    tmax_p = tan_umax
    ahat_p = rest / torch.clamp(2.0 * tmax_p, min=1e-9)
    t_p = torch.tan(u)
    r_par = 2.0 * ahat_p * (1.0 + t_p * t_p) ** 1.5

    return torch.where(rhat == 1.0, r_circle,
                       torch.where(rhat > 0.0, r_ell,
                                   torch.where(rhat < 0.0, r_hyp, r_par)))


def _smoothstep01(x):
    t = torch.clamp(x, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _integrand(res, wi, wo, p_alpha, p_beta, p_ss, p_hw):
    """The specular integrand times the gain-independent geometry. wi, wo
    are in the unrotated local frame; the weft rotation is applied here
    (irawan.cpp:243-256)."""
    is_weft = res["is_weft"]

    def rot(d):
        return torch.stack([torch.where(is_weft, -d[..., 1], d[..., 0]),
                            torch.where(is_weft, d[..., 0], d[..., 1]),
                            d[..., 2]], -1)

    om_i = rot(wi)
    om_r = rot(wo)
    u = res["u"]
    v = res["v"]
    umax = res["umax"]
    psi = res["psi"]
    kappa = res["kappa"]
    w = res["w"]
    length = res["l"]

    hs = om_i + om_r
    sum_len = torch.sqrt(_dot(hs, hs))
    h = hs / torch.clamp(sum_len, min=1e-12)[..., None]
    h0, h1, h2 = h[..., 0], h[..., 1], h[..., 2]
    fc = p_alpha + _von_mises(-_dot(om_i, om_r), p_beta)
    a = 0.5 * w
    guards = (w * torch.sin(umax) < length) & (kappa >= -1.0)

    # ---- filament (psi == 0); irawan.cpp:383-464 -------------------------
    u_of_v = torch.atan(h1 / torch.where(torch.abs(h2) > 1e-12, h2, 1e-12))
    in_f = torch.abs(u_of_v) < umax
    n_f = _normalize(torch.stack([torch.sin(v), torch.sin(u_of_v)
                                  * torch.cos(v),
                                  torch.cos(u_of_v) * torch.cos(v)], -1))
    tf1 = torch.cos(u_of_v)
    tf2 = -torch.sin(u_of_v)
    ss_umax = (1.0 - p_ss) * umax
    r_f = _radius_of_curvature(torch.minimum(torch.abs(u_of_v), ss_umax),
                               torch.clamp(ss_umax, min=1e-6), kappa, w,
                               length)
    tch_x = tf1 * h2 - tf2 * h1
    gu = a * (r_f + a * torch.cos(v)) \
        / torch.clamp(sum_len * torch.abs(tch_x), min=1e-12)
    a_f = _seeliger(_dot(n_f, om_i), _dot(n_f, om_r))
    as_f = torch.where(p_ss > 0.0,
                       a_f * (1.0 - _smoothstep01(
                           (torch.abs(u_of_v) - ss_umax)
                           / torch.clamp(p_ss * umax, min=1e-9))),
                       a_f)
    fs_f = gu * fc * as_f * math.pi * length
    dy = length * p_hw
    umax_c = torch.clamp(umax, min=1e-9)
    y_of_v = torch.clamp(u_of_v * 0.5 * length / umax_c,
                         0.5 * (dy - length), 0.5 * (length - dy))
    sel_f = torch.abs(y_of_v - u * 0.5 * length / umax_c) < 0.5 * dy
    val_f = torch.where(in_f & sel_f & (p_ss < 1.0) & (p_ss >= 0.0),
                        fs_f / torch.clamp(dy, min=1e-9), 0.0)

    # ---- staple (psi != 0); irawan.cpp:466-549 ---------------------------
    sin_u, cos_u = torch.sin(u), torch.cos(u)
    denom_d = torch.sqrt(torch.clamp(
        h0 ** 2 + (h1 * sin_u + h2 * cos_u) ** 2, min=1e-12)) \
        * torch.tan(torch.where(torch.abs(psi) > 1e-9, psi, 1.0))
    d_st = (h1 * cos_u - h2 * sin_u) \
        / torch.where(torch.abs(denom_d) > 1e-12, denom_d, 1e-12)
    v_of_u = torch.atan2(-h1 * sin_u - h2 * cos_u, h0) \
        + torch.acos(torch.clamp(d_st, -1.0, 1.0))
    in_s = (torch.abs(d_st) < 1.0) & (torch.abs(v_of_u) < math.pi / 2.0)
    n_s = _normalize(torch.stack([torch.sin(v_of_u),
                                  sin_u * torch.cos(v_of_u),
                                  cos_u * torch.cos(v_of_u)], -1))
    r_s = _radius_of_curvature(torch.abs(u), torch.clamp(umax, min=1e-6),
                               kappa, w, length)
    den_s = sum_len * _dot(n_s, h) * torch.abs(torch.sin(psi))
    gv = a * (r_s + a * torch.cos(v_of_u)) \
        / torch.where(torch.abs(den_s) > 1e-12, den_s, 1e-12)
    a_s = _seeliger(_dot(n_s, om_i), _dot(n_s, om_r))
    fs_s = gv * fc * a_s * 2.0 * w * umax
    dxw = w * p_hw
    x_of_u = torch.clamp(v_of_u * w / math.pi,
                         0.5 * (dxw - w), 0.5 * (w - dxw))
    sel_s = torch.abs(x_of_u - v * w / math.pi) < 0.5 * dxw
    val_s = torch.where(in_s & sel_s, fs_s / torch.clamp(dxw, min=1e-9),
                        0.0)

    val = torch.where(torch.abs(psi) > 1e-9, val_s, val_f)
    val = torch.where(guards, val, 0.0)
    # front side only, with the trailing cosTheta(wo) of eval()
    cos_ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(cos_ok, torch.clamp(val, min=0.0) * wo[..., 2], 0.0)


# ---------------------------------------------------------------------------
# family module (registry dispatch)
# ---------------------------------------------------------------------------

def _cloth_res_from_gm(gm):
    return dict(u=gm.exponent, v=gm.alpha, umax=gm.beta_r,
                psi=gm.scale_tilt, kappa=gm.eta, w=gm.sigma_a[..., 0],
                l=gm.sigma_a[..., 1], is_weft=gm.sigma_a[..., 2] > 0.5)


class Cloth:
    @staticmethod
    def eval_pdf(gm, wi, wo, aux):
        res = _cloth_res_from_gm(gm)
        spec = _integrand(res, wi, wo, gm.transmit[..., 0],
                          gm.transmit[..., 1], gm.transmit[..., 2],
                          gm.k[..., 0])
        cos_ok = (wi[..., 2] > 0) & (wo[..., 2] > 0)
        f = gm.specular * spec[..., None] \
            + torch.where(cos_ok, wo[..., 2], 0.0)[..., None] \
            * gm.diffuse / math.pi
        pdf = torch.where(cos_ok, wo[..., 2] / math.pi, 0.0)
        return f, pdf

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux):
        n = wi.shape[:-1]
        # cosine-hemisphere sampling, as the reference (irawan.cpp:345)
        r = torch.sqrt(torch.clamp(u2[..., 0], min=0.0))
        phi = 2.0 * math.pi * u2[..., 1]
        wo = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                          torch.sqrt(torch.clamp(1.0 - u2[..., 0], min=0.0))],
                         -1)
        f, pdf = Cloth.eval_pdf(gm, wi, wo, aux)
        weight = f / torch.clamp(pdf, min=1e-9)[..., None]
        weight = torch.where((pdf > 0)[..., None], weight, 0.0)
        return (wo, weight, pdf,
                torch.zeros(n, dtype=torch.bool, device=wi.device),
                torch.ones(n, dtype=wi.dtype, device=wi.device))


R.register(CLOTH_KIND, Cloth)
