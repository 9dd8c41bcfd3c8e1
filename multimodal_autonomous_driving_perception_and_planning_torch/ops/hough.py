"""Deterministic Hough line transform, as tensor ops.

Port of the JAX package's ops/hough.py, the dense (standard) Hough
transform that stands in for cv2.HoughLinesP:

  1. edge pixels are compacted into a fixed-capacity list in row-major scan
     order (`compact_mask`: an int32 prefix sum and a scatter);
  2. every listed pixel votes once a theta into a (theta, rho) grid of
     int32 counts (``index_add_``);
  3. peaks are local maxima of a 5x5 window above the vote threshold, ties
     broken toward the first bin in scan order; the strongest ``max_lines``
     of them are taken from a pool of the first peaks in scan order;
  4. each peak line becomes one segment, the extremes of its supporting
     pixels' projections.

The float arithmetic is the JAX package's under ``jit``, where XLA's CPU
compiler contracts a product-sum ``a*x + b*y`` into ``fma(a, x, b*y)``: the
port computes ``rho``, the coarse support and the projections that way
(`fma32`), and computes XLA's float32 ``cos``/``sin`` of the theta grid as
XLA's CPU backend does, by glibc's ``cosf``/``sinf`` algorithm (`sincosf`),
as neither torch's nor a correctly rounded ``cos`` gives them.
With ``refine=True`` the tight support leans on ``atan2``, ``cos`` and
``sin`` of data, where torch and XLA may stand ulps apart.  The JAX
package's bf16/float32 matmul compaction and one-hot histogram are TPU
workarounds and are not copied.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .geometry import fma32


class HoughLines(NamedTuple):
    segments: torch.Tensor  # (L, 4) float32 x1, y1, x2, y2
    valid: torch.Tensor  # (L,) bool
    votes: torch.Tensor  # (L,) int32
    length: torch.Tensor  # (L,) float32
    overflow: torch.Tensor  # () bool: the peak pool overflowed
    edges_overflow: torch.Tensor  # () bool: more edge pixels than the capacity


# XLA's float32 cos and sin of jnp.arange(180, dtype=float32) * (pi / 180)
# (the theta grid at LaneConfig.num_thetas = 180), generated once with jnp
# on the CPU; tests/test_torch_hough.py regenerates them.  They are the
# check of `sincosf` (`CARRIED_TABLES`), which computes every grid.
# fmt: off
_XLA_COS_180 = (
    1.0, 0.9998477101325989, 0.9993908405303955, 0.9986295104026794,
    0.9975640773773193, 0.9961947202682495, 0.9945219159126282, 0.9925461411476135,
    0.9902680516242981, 0.9876883625984192, 0.9848077297210693, 0.9816271662712097,
    0.9781476259231567, 0.9743700623512268, 0.9702957272529602, 0.9659258127212524,
    0.9612616896629333, 0.9563047885894775, 0.9510565400123596, 0.9455185532569885,
    0.9396926164627075, 0.9335803985595703, 0.9271838665008545, 0.9205048680305481,
    0.9135454297065735, 0.9063077569007874, 0.8987940549850464, 0.8910065293312073,
    0.882947564125061, 0.874619722366333, 0.8660253882408142, 0.8571673035621643,
    0.8480480909347534, 0.838670551776886, 0.829037606716156, 0.8191520571708679,
    0.80901700258255, 0.7986355423927307, 0.7880107760429382, 0.7771459221839905,
    0.7660444378852844, 0.7547096014022827, 0.7431448101997375, 0.7313537001609802,
    0.7193397879600525, 0.7071067690849304, 0.6946583986282349, 0.6819983720779419,
    0.6691305637359619, 0.6560590267181396, 0.6427876353263855, 0.6293204426765442,
    0.6156615018844604, 0.6018150448799133, 0.5877853035926819, 0.5735764503479004,
    0.5591928958892822, 0.5446390509605408, 0.5299192667007446, 0.5150380730628967,
    0.4999999701976776, 0.4848095774650574, 0.46947160363197327, 0.45399051904678345,
    0.4383711516857147, 0.42261824011802673, 0.4067366123199463, 0.39073118567466736,
    0.3746066391468048, 0.3583679795265198, 0.3420201539993286, 0.32556813955307007,
    0.30901697278022766, 0.2923717796802521, 0.2756373882293701, 0.2588190734386444,
    0.24192190170288086, 0.22495104372501373, 0.2079116553068161, 0.19080905616283417,
    0.17364822328090668, 0.15643449127674103, 0.13917310535907745, 0.12186932563781738,
    0.10452841967344284, 0.08715580403804779, 0.06975650787353516, 0.05233597382903099,
    0.03489949554204941, 0.017452383413910866, -4.371138828673793e-08,
    -0.01745235174894333, -0.03489946201443672, -0.052335940301418304,
    -0.06975647807121277, -0.0871557667851448, -0.10452850908041, -0.1218692883849144,
    -0.13917307555675507, -0.15643444657325745, -0.1736481934785843,
    -0.19080902636051178, -0.2079116255044937, -0.22495101392269135,
    -0.24192187190055847, -0.258819043636322, -0.27563735842704773,
    -0.2923717498779297, -0.3090169429779053, -0.3255681097507477, -0.3420201241970062,
    -0.3583679497241974, -0.3746066093444824, -0.39073115587234497,
    -0.4067365825176239, -0.4226183295249939, -0.43837112188339233,
    -0.4539903998374939, -0.4694715738296509, -0.484809547662735, -0.5000000596046448,
    -0.515038013458252, -0.5299193263053894, -0.5446390509605408, -0.5591928362846375,
    -0.5735764503479004, -0.5877851843833923, -0.6018151044845581, -0.6156614422798157,
    -0.6293203234672546, -0.6427876353263855, -0.6560589671134949, -0.6691306829452515,
    -0.6819983124732971, -0.6946582794189453, -0.7071067690849304, -0.7193397283554077,
    -0.731353759765625, -0.7431448101997375, -0.7547096610069275, -0.7660444378852844,
    -0.7771458625793457, -0.7880107760429382, -0.7986354827880859, -0.8090170621871948,
    -0.8191520571708679, -0.8290374875068665, -0.838670551776886, -0.8480480313301086,
    -0.8571673035621643, -0.8660253882408142, -0.8746197819709778, -0.882947564125061,
    -0.8910064697265625, -0.8987940549850464, -0.9063077569007874, -0.9135454893112183,
    -0.9205048680305481, -0.9271838068962097, -0.9335804581642151, -0.9396926164627075,
    -0.9455186128616333, -0.9510564804077148, -0.9563047289848328, -0.9612616896629333,
    -0.9659258127212524, -0.9702957272529602, -0.9743700623512268, -0.9781476259231567,
    -0.9816271662712097, -0.9848077297210693, -0.9876883625984192, -0.9902680516242981,
    -0.9925461411476135, -0.9945219159126282, -0.9961946606636047, -0.9975640773773193,
    -0.9986295104026794, -0.9993908405303955, -0.9998477101325989,
)

_XLA_SIN_180 = (
    0.0, 0.017452405765652657, 0.03489949554204941, 0.0523359589278698,
    0.06975647062063217, 0.08715573698282242, 0.10452846437692642, 0.12186934798955917,
    0.13917310535907745, 0.15643447637557983, 0.1736481785774231, 0.1908089965581894,
    0.20791170001029968, 0.22495105862617493, 0.24192190170288086, 0.258819043636322,
    0.27563735842704773, 0.2923716902732849, 0.30901700258255005, 0.32556816935539246,
    0.3420201241970062, 0.3583679497241974, 0.3746066093444824, 0.3907311260700226,
    0.4067366421222687, 0.4226182699203491, 0.4383711516857147, 0.45399048924446106,
    0.4694715738296509, 0.48480960726737976, 0.5, 0.5150380730628967,
    0.5299192667007446, 0.5446390509605408, 0.5591928958892822, 0.5735764503479004,
    0.5877852439880371, 0.6018149852752686, 0.6156615018844604, 0.6293203830718994,
    0.6427875757217407, 0.6560590267181396, 0.6691306233406067, 0.6819983720779419,
    0.6946583986282349, 0.7071067690849304, 0.7193397879600525, 0.7313537001609802,
    0.7431448698043823, 0.7547095417976379, 0.7660444378852844, 0.7771459221839905,
    0.7880107164382935, 0.7986355423927307, 0.80901700258255, 0.8191520571708679,
    0.8290375471115112, 0.838670551776886, 0.8480480909347534, 0.8571673035621643,
    0.866025447845459, 0.874619722366333, 0.882947564125061, 0.8910065293312073,
    0.8987940549850464, 0.9063078165054321, 0.9135454893112183, 0.9205048084259033,
    0.9271838665008545, 0.9335803985595703, 0.9396926164627075, 0.9455185532569885,
    0.9510565400123596, 0.9563047289848328, 0.9612616896629333, 0.9659258127212524,
    0.9702957272529602, 0.9743700623512268, 0.9781476259231567, 0.9816271662712097,
    0.9848077297210693, 0.9876883625984192, 0.9902680516242981, 0.9925461411476135,
    0.9945219159126282, 0.9961947202682495, 0.9975640773773193, 0.9986295104026794,
    0.9993908405303955, 0.9998477101325989, 1.0, 0.9998477101325989,
    0.9993908405303955, 0.9986295104026794, 0.9975640773773193, 0.9961947202682495,
    0.9945219159126282, 0.9925461411476135, 0.9902680516242981, 0.9876883625984192,
    0.9848077297210693, 0.9816271662712097, 0.9781476259231567, 0.9743700623512268,
    0.9702957272529602, 0.9659258127212524, 0.9612616896629333, 0.9563047289848328,
    0.9510565400123596, 0.9455186128616333, 0.9396926164627075, 0.9335804581642151,
    0.9271838665008545, 0.9205048680305481, 0.9135454893112183, 0.9063077569007874,
    0.8987940549850464, 0.891006588935852, 0.882947564125061, 0.874619722366333,
    0.8660253882408142, 0.8571673035621643, 0.8480480313301086, 0.838670551776886,
    0.829037606716156, 0.8191519975662231, 0.80901700258255, 0.7986354827880859,
    0.7880107760429382, 0.77714604139328, 0.7660444378852844, 0.7547096014022827,
    0.7431448101997375, 0.7313537001609802, 0.719339907169342, 0.7071067690849304,
    0.6946584582328796, 0.6819983124732971, 0.6691306233406067, 0.6560589671134949,
    0.6427876353263855, 0.629320502281189, 0.6156614422798157, 0.6018151044845581,
    0.5877851843833923, 0.5735764503479004, 0.5591930150985718, 0.5446390509605408,
    0.5299193263053894, 0.515038013458252, 0.5000000596046448, 0.484809547662735,
    0.4694715738296509, 0.4539905786514282, 0.43837112188339233, 0.4226183295249939,
    0.4067365825176239, 0.39073115587234497, 0.3746066987514496, 0.358367919921875,
    0.3420202136039734, 0.3255681097507477, 0.30901703238487244, 0.29237183928489685,
    0.27563735842704773, 0.2588191330432892, 0.24192185699939728, 0.2249511182308197,
    0.20791161060333252, 0.19080901145935059, 0.17364829778671265, 0.15643444657325745,
    0.13917317986488342, 0.1218692809343338, 0.10452849417924881, 0.08715587854385376,
    0.06975647062063217, 0.05233604833483696, 0.034899450838565826,
    0.017452457919716835,
)
# The same of jnp.arange(90, dtype=float32) * (pi / 90), the grid of
# tests/test_config_sweep.py's frames case.
_XLA_COS_90 = (
    1.0, 0.9993908405303955, 0.9975640773773193, 0.9945219159126282, 0.9902680516242981,
    0.9848077297210693, 0.9781476259231567, 0.9702957272529602, 0.9612616896629333,
    0.9510565400123596, 0.9396926164627075, 0.9271838665008545, 0.9135454297065735,
    0.8987940549850464, 0.882947564125061, 0.8660253882408142, 0.8480480909347534,
    0.829037606716156, 0.80901700258255, 0.7880107760429382, 0.7660444378852844,
    0.7431448101997375, 0.7193397879600525, 0.6946583986282349, 0.6691305637359619,
    0.6427876353263855, 0.6156615018844604, 0.5877853035926819, 0.5591928958892822,
    0.5299192667007446, 0.4999999701976776, 0.46947160363197327, 0.4383711516857147,
    0.4067366123199463, 0.3746066391468048, 0.3420201539993286, 0.30901697278022766,
    0.2756373882293701, 0.24192190170288086, 0.2079116553068161, 0.17364822328090668,
    0.13917310535907745, 0.10452841967344284, 0.06975650787353516, 0.03489949554204941,
    -4.371138828673793e-08, -0.03489946201443672, -0.06975647807121277,
    -0.10452850908041, -0.13917307555675507, -0.1736481934785843, -0.2079116255044937,
    -0.24192187190055847, -0.27563735842704773, -0.3090169429779053,
    -0.3420201241970062, -0.3746066093444824, -0.4067365825176239, -0.43837112188339233,
    -0.4694715738296509, -0.5000000596046448, -0.5299193263053894, -0.5591928362846375,
    -0.5877851843833923, -0.6156614422798157, -0.6427876353263855, -0.6691306829452515,
    -0.6946582794189453, -0.7193397283554077, -0.7431448101997375, -0.7660444378852844,
    -0.7880107760429382, -0.8090170621871948, -0.8290374875068665, -0.8480480313301086,
    -0.8660253882408142, -0.882947564125061, -0.8987940549850464, -0.9135454893112183,
    -0.9271838068962097, -0.9396926164627075, -0.9510564804077148, -0.9612616896629333,
    -0.9702957272529602, -0.9781476259231567, -0.9848077297210693, -0.9902680516242981,
    -0.9945219159126282, -0.9975640773773193, -0.9993908405303955,
)
_XLA_SIN_90 = (
    0.0, 0.03489949554204941, 0.06975647062063217, 0.10452846437692642,
    0.13917310535907745, 0.1736481785774231, 0.20791170001029968, 0.24192190170288086,
    0.27563735842704773, 0.30901700258255005, 0.3420201241970062, 0.3746066093444824,
    0.4067366421222687, 0.4383711516857147, 0.4694715738296509, 0.5, 0.5299192667007446,
    0.5591928958892822, 0.5877852439880371, 0.6156615018844604, 0.6427875757217407,
    0.6691306233406067, 0.6946583986282349, 0.7193397879600525, 0.7431448698043823,
    0.7660444378852844, 0.7880107164382935, 0.80901700258255, 0.8290375471115112,
    0.8480480909347534, 0.866025447845459, 0.882947564125061, 0.8987940549850464,
    0.9135454893112183, 0.9271838665008545, 0.9396926164627075, 0.9510565400123596,
    0.9612616896629333, 0.9702957272529602, 0.9781476259231567, 0.9848077297210693,
    0.9902680516242981, 0.9945219159126282, 0.9975640773773193, 0.9993908405303955, 1.0,
    0.9993908405303955, 0.9975640773773193, 0.9945219159126282, 0.9902680516242981,
    0.9848077297210693, 0.9781476259231567, 0.9702957272529602, 0.9612616896629333,
    0.9510565400123596, 0.9396926164627075, 0.9271838665008545, 0.9135454893112183,
    0.8987940549850464, 0.882947564125061, 0.8660253882408142, 0.8480480313301086,
    0.829037606716156, 0.80901700258255, 0.7880107760429382, 0.7660444378852844,
    0.7431448101997375, 0.719339907169342, 0.6946584582328796, 0.6691306233406067,
    0.6427876353263855, 0.6156614422798157, 0.5877851843833923, 0.5591930150985718,
    0.5299193263053894, 0.5000000596046448, 0.4694715738296509, 0.43837112188339233,
    0.4067365825176239, 0.3746066987514496, 0.3420202136039734, 0.30901703238487244,
    0.27563735842704773, 0.24192185699939728, 0.20791161060333252, 0.17364829778671265,
    0.13917317986488342, 0.10452849417924881, 0.06975647062063217, 0.034899450838565826,
)
# fmt: on
CARRIED_TABLES = {90: (_XLA_COS_90, _XLA_SIN_90), 180: (_XLA_COS_180, _XLA_SIN_180)}

# glibc's float32 sine and cosine (sysdeps/ieee754/flt-32: s_sinf.c,
# s_cosf.c, sincosf.h, sincosf_data.c), which XLA's CPU backend calls for
# jnp.cos and jnp.sin and constant folding evaluates with: the argument in
# double, one multiply-subtract by pi/2 (|x| < 120), and double-precision
# polynomials rounded once to float32.
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")  # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")  # pi/2
_COS_POLY = tuple(float.fromhex(c) for c in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN_POLY = tuple(float.fromhex(c) for c in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))


def _abstop12(y: np.ndarray) -> np.ndarray:
    """The float32's top 12 bits with the sign cleared (glibc's `abstop12`)."""
    return (y.view(np.uint32) >> 20) & 0x7FF


def _sinf_poly(x: np.ndarray, x2: np.ndarray, negate: np.ndarray, odd: np.ndarray) -> np.ndarray:
    """glibc's `sinf_poly`: the sine polynomial of x where ``odd`` is false,
    else the cosine polynomial (negated in its second table, ``negate``)."""
    x3 = x * x2
    s1 = _SIN_POLY[1] + x2 * _SIN_POLY[2]
    sin = (x + x3 * _SIN_POLY[0]) + (x3 * x2) * s1
    c = [np.where(negate, -k, k) for k in _COS_POLY]
    x4 = x2 * x2
    c2 = c[3] + x2 * c[4]
    c1 = c[0] + x2 * c[1]
    cos = (c1 + x4 * c[2]) + (x4 * x2) * c2
    return np.where(odd, cos, sin)


def sincosf(y: np.ndarray, cosine: bool) -> np.ndarray:
    """glibc's ``cosf`` (``cosine``) or ``sinf`` of float32 ``y``, |y| < 120,
    in numpy float64 arithmetic, bit for bit: so on any host, XLA's CPU
    values."""
    y = np.asarray(y, dtype=np.float32)
    top = _abstop12(y)
    if (top >= _abstop12(np.float32(120.0))).any():
        raise ValueError("sincosf: |y| < 120 only (glibc's one-step reduction)")
    x = y.astype(np.float64)
    small = top < _abstop12(np.float32(float.fromhex("0x1.921FB6p-1")))  # below pi/4, by its top bits
    tiny = top < _abstop12(np.float32(2.0**-12))
    n = (np.trunc(x * _HPI_INV).astype(np.int64) + 0x800000) >> 24  # the quadrant
    r = x - n * _HPI
    sign = np.array([1.0, -1.0, -1.0, 1.0])[n & 3]
    reduced = _sinf_poly(r * sign, r * r, (n & 2) != 0, ((n ^ 1) if cosine else n) & 1)
    near = _sinf_poly(x, x * x, np.zeros(y.shape, bool), np.full(y.shape, cosine))
    out = np.where(small, np.where(tiny, 1.0 if cosine else x, near), reduced)
    return out.astype(np.float32)


def theta_grid(num_thetas: int) -> np.ndarray:
    """The JAX package's theta grid, jnp.arange(n, dtype=float32) * (pi / n)
    in float32."""
    return np.arange(num_thetas, dtype=np.float32) * np.float32(math.pi / num_thetas)


@functools.lru_cache(maxsize=None)
def theta_tables(num_thetas: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """XLA's float32 (cos, sin) of the theta grid of any size, on ``device``
    (made once a device)."""
    if num_thetas < 1:
        raise ValueError(f"num_thetas={num_thetas}: the grid needs at least one theta")
    theta = theta_grid(num_thetas)
    return (torch.from_numpy(sincosf(theta, True)).to(device), torch.from_numpy(sincosf(theta, False)).to(device))


def compact_mask(flat: torch.Tensor, capacity: int):
    """Indices of the first ``capacity`` set entries of a flat bool mask, in
    ascending order, 0 past the end, with no host read: an int32 prefix sum
    gives each set entry its slot, and a scatter writes it (entries past the
    capacity go to a slot that is dropped).

    Returns (idx (capacity,) int32, valid (capacity,) bool, total () int32).
    """
    n = flat.shape[0]
    f = flat.to(torch.int32)
    slot = torch.cumsum(f, 0, dtype=torch.int32) - 1
    total = slot[-1] + 1
    slot = torch.where(flat.bool() & (slot < capacity), slot, capacity).long()
    idx = torch.zeros(capacity + 1, dtype=torch.int32, device=flat.device)
    idx.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=flat.device))
    valid = torch.arange(capacity, device=flat.device) < total
    return torch.where(valid, idx[:capacity], 0), valid, total


def compact_edges(edges: torch.Tensor, capacity: int, row_range=None):
    """(H, W) bool -> the fixed-size edge-pixel list (x, y, valid) in
    row-major scan order, and the total edge count.  ``row_range=(y0, y1)``
    scans only rows [y0, y1), where the caller knows the mask lives."""
    y0 = 0
    if row_range is not None:
        y0, y1 = row_range
        edges = edges[y0:y1]
    w = edges.shape[1]
    idx, valid, total = compact_mask(edges.reshape(-1), capacity)
    x = (idx % w).to(torch.float32)
    y = (idx // w + y0).to(torch.float32)
    return x, y, valid, total


def project(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor, y: torch.Tensor, neg_a: bool = False) -> torch.Tensor:
    """``a[:, None] * x + b[:, None] * y`` ((L,) by (K,) -> (L, K)), or
    ``-a[:, None] * x + b[:, None] * y`` with ``neg_a``, as XLA's CPU code
    contracts it: ``fma(a, x, b*y)``, and where ``a`` is negated the other
    product fused, ``fma(b, y, -(a*x))``."""
    shape = (a.shape[0], x.shape[0])
    a, b = a[:, None].expand(shape), b[:, None].expand(shape)
    xs, ys = x[None, :].expand(shape), y[None, :].expand(shape)
    if neg_a:
        return fma32(b, ys, -(a * xs))
    return fma32(a, xs, b * ys)


def _roll2(a: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    return torch.roll(a, (di, dj), (0, 1))


def _peaks(acc: torch.Tensor, vote_threshold: int) -> torch.Tensor:
    """5x5 local maxima of the accumulator, wrapping at both borders like
    ``jnp.roll``, a tie going to the first bin in row-major scan order:
    ``acc`` equals the window's max and exceeds every earlier neighbour."""
    colmax5 = acc
    for dj in (-2, -1, 1, 2):
        colmax5 = torch.maximum(colmax5, _roll2(acc, 0, -dj))
    win_max = colmax5
    for di in (-2, -1, 1, 2):
        win_max = torch.maximum(win_max, _roll2(colmax5, -di, 0))
    before_max = torch.maximum(
        torch.maximum(_roll2(colmax5, 1, 0), _roll2(colmax5, 2, 0)),
        torch.maximum(_roll2(acc, 0, 1), _roll2(acc, 0, 2)),
    )
    return (acc == win_max) & (acc > before_max) & (acc >= vote_threshold)


def vote(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor, num_thetas: int, diag: int) -> torch.Tensor:
    """The (num_thetas, 2 diag + 1) int32 accumulator: every valid pixel of
    the list votes once a theta, into bin round(rho) + diag, ``rho`` as
    compiled XLA computes it."""
    dev = x.device
    n_rho = 2 * diag + 1
    cos_t, sin_t = theta_tables(num_thetas, torch.device(dev))
    rho_idx = torch.round(project(cos_t, sin_t, x, y)).to(torch.int64) + diag
    flat_bin = (torch.arange(num_thetas, device=dev)[:, None] * n_rho + rho_idx).reshape(-1)
    acc = torch.zeros(num_thetas * n_rho, dtype=torch.int32, device=dev)
    acc.index_add_(0, flat_bin, valid.to(torch.int32)[None, :].expand(num_thetas, -1).reshape(-1))
    return acc.view(num_thetas, n_rho)


def select_peaks(acc: torch.Tensor, vote_threshold: int, max_lines: int):
    """The strongest ``max_lines`` peaks: every 5x5 peak in scan order into
    a pool of max(4 max_lines, 256), then the pool's top ``max_lines`` by
    votes, ties in pool (scan) order as lax.top_k.  Returns (votes (L,)
    int32, flat bin (L,) int64, pool overflow () bool)."""
    is_peak = _peaks(acc, vote_threshold)
    pool_size = max(4 * max_lines, 256)
    pool_idx, pool_valid, total_peaks = compact_mask(is_peak.reshape(-1), pool_size)
    pool_scores = torch.where(pool_valid, acc.reshape(-1)[pool_idx.long()], 0)
    scores, in_pool = torch.sort(pool_scores, descending=True, stable=True)
    flat_idx = pool_idx[in_pool[:max_lines]].long()
    return scores[:max_lines], flat_idx, total_peaks > pool_size


def segments_from_peaks(x, y, valid, scores, flat_idx, diag: int, num_thetas: int, min_line_length: float,
                        refine: bool):
    """One segment a peak line: its coarse support (|distance| <= 2 px),
    with ``refine`` a total-least-squares line and its tight support
    (<= 1.5 px), the extremes of the support's projections, then the kept
    lines (votes, support, length) less exact duplicates of an earlier one.
    Returns (segments (L, 4), keep (L,), length (L,))."""
    dev = x.device
    n_rho = 2 * diag + 1
    cos_t, sin_t = theta_tables(num_thetas, torch.device(dev))
    line_valid = scores > 0
    t_idx = flat_idx // n_rho
    r_idx = flat_idx % n_rho
    L = flat_idx.shape[0]
    ct, st = cos_t[t_idx], sin_t[t_idx]
    line_rho = (r_idx - diag).to(torch.float32)

    # Coarse support, generous for the 1-degree grid's mis-angle.
    d0 = (project(ct, st, x, y) - line_rho[:, None]).abs()
    support0 = (d0 <= 2.0) & valid[None, :]
    w0 = support0.to(torch.float32)
    n0 = torch.clamp(w0.sum(1), min=1.0)
    mx = (w0 * x[None, :]).sum(1) / n0  # integer sums: exact in any order
    my = (w0 * y[None, :]).sum(1) / n0

    if refine:
        # Total least squares over the support (closed-form 2x2 PCA).
        dxc = (x[None, :] - mx[:, None]) * w0
        dyc = (y[None, :] - my[:, None]) * w0
        sxx = (dxc * dxc).sum(1)
        sxy = (dxc * dyc).sum(1)
        syy = (dyc * dyc).sum(1)
        phi = 0.5 * torch.atan2(2.0 * sxy, sxx - syy)
        dirx, diry = torch.cos(phi), torch.sin(phi)
        # The tight support against the refined normal (-diry, dirx).
        rho_ref = fma32(dirx, my, -(diry * mx))
        d1 = (project(diry, dirx, x, y, neg_a=True) - rho_ref[:, None]).abs()
        support = (d1 <= 1.5) & valid[None, :]
        t_par = project(dirx, diry, x, y)
        t_mean = fma32(dirx, mx, diry * my)
    else:
        # Feature-only mode: the grid theta's direction (-sin, cos).
        support = support0
        t_par = project(st, ct, x, y, neg_a=True)
        t_mean = fma32(ct, my, -(st * mx))

    # Projection extremes along the line direction.
    t_min = torch.where(support, t_par, 1e9).amin(1)
    t_max = torch.where(support, t_par, -1e9).amax(1)
    has_support = support.any(1)
    length = torch.where(has_support, t_max - t_min, 0.0)

    lo, hi = t_min - t_mean, t_max - t_mean
    if refine:
        segments = torch.stack([fma32(lo, dirx, mx), fma32(lo, diry, my), fma32(hi, dirx, mx), fma32(hi, diry, my)], -1)
    else:
        segments = torch.stack([fma32(-lo, st, mx), fma32(lo, ct, my), fma32(-hi, st, mx), fma32(hi, ct, my)], -1)

    keep = line_valid & has_support & (length >= min_line_length)
    # Drop exact duplicates of an earlier kept segment (distinct peaks whose
    # supports resolve to the same pixels).
    same = (segments[:, None, :] == segments[None, :, :]).all(-1)
    ar = torch.arange(L, device=dev)
    dup = (same & (ar[None, :] < ar[:, None]) & keep[None, :]).any(1)
    keep = keep & ~dup
    return torch.where(keep[:, None], segments, 0.0), keep, length


def hough_segments(
    edges: torch.Tensor,
    vote_threshold: int,
    min_line_length: float,
    num_thetas: int = 180,
    max_lines: int = 64,
    edge_capacity: int = 8192,
    row_range=None,
    refine: bool = True,
) -> HoughLines:
    """Dense Hough transform and segment reconstruction of an (H, W) bool
    edge map: rho resolution 1 px, theta resolution pi / ``num_thetas``.
    At most ``edge_capacity`` edge pixels vote (the first in scan order;
    ``edges_overflow`` says when more were set).  ``refine=False`` is the
    feature-only mode: the grid theta's direction and the coarse support.
    The stages (`compact_edges`, `vote`, `select_peaks`,
    `segments_from_peaks`) are public, for checks of their own."""
    h, w = edges.shape
    diag = int(math.ceil(math.sqrt(h * h + w * w)))
    x, y, valid, n_edges = compact_edges(edges, edge_capacity, row_range)
    acc = vote(x, y, valid, num_thetas, diag)
    scores, flat_idx, overflow = select_peaks(acc, vote_threshold, max_lines)
    segments, keep, length = segments_from_peaks(x, y, valid, scores, flat_idx, diag, num_thetas,
                                                 min_line_length, refine)
    return HoughLines(
        segments=segments,
        valid=keep,
        votes=scores.to(torch.int32),
        length=length,
        overflow=overflow,
        edges_overflow=n_edges > edge_capacity,
    )
