"""The multi-scalar multiplication on the card: the CUDA Pippenger of
`csrc/msm.cu` (kernel M1) and its plain PyTorch version.

Counterpart of `sunscreen_tpu/zk/tpu_curve.py`, whose `msm_tpu_fn` (plain
JAX under `jax.jit`, not a Pallas kernel) is the reference ZK stack's one
device function. `msm(scalars, points)` takes the scalars as a uint8 tensor
[n, 32] (little-endian, reduced mod L) and the points as uint8 [n, 128]
(X, Y, Z, T, 32 little-endian bytes each: `native.points_to_buf`), and
returns the sum as uint8 [128] in the same layout, each coordinate below
2^256 but not always below p. On a CUDA tensor it launches the kernel (and
raises if it cannot); on a CPU tensor it runs the plain version, which
tests and `chip_smoke.py` use as the oracle.

The kernel (three launches a call; `csrc/msm.cu`'s header has the
design): the digits of every window and the points' cached forms, a
stable counting sort of the point indices by digit per window, and the
buckets' running sums in equal shares of each window's events over teams
of four lanes (`bucket_shape`: blocks of up to TEAMS teams, about TARGET_TEAMS
in all, for shares of at least MIN_EVENTS events), each window's sum by its last block, and the join of the windows
by one more block's team, which starts on the top window while the lower
ones are still summed. Every point operation runs on four lanes, one
coordinate each. The wrapper allocates the scratch (`scratch`);
`join_times` reads the join's own time, the chain floor, from it.

The plain version keeps the reference's field: 9 x 29-bit limbs, here in
int64 (products stay below 2^58, 9-term sums below 2^62, and CPU PyTorch
has no uint64 arithmetic), with the reference's `fmul`/`fadd`/`fsub`/`padd`
ported limb for limb. Its MSM is Pippenger in tensors: the digits of all
windows at once, every non-empty bucket summed by a segmented pairwise
tree, each window's sum of b S_b from the bits of b, and the windows
joined by c doublings each on the host's python group
(`zk/curve25519.py`), which is exact and a few milliseconds for
ceil(253 / c) points.
"""

from __future__ import annotations

import torch

from sunscreen_tpu_torch import _build
from sunscreen_tpu_torch.zk import curve25519 as cv
from sunscreen_tpu_torch.zk import native

SCALAR_BITS = 253
MAX_C = 12                   # the sort's [warps][2^c] table fits shared memory
TEAMS = 32                   # teams of four lanes a block of the bucket kernel
MIN_EVENTS = 8               # the least events (points, bucket ends) a team
TARGET_TEAMS = 132 * 128     # teams a launch aims for: 128 an H100 SM

P = cv.P
NLIMB = 9
LBITS = 29
LMASK = (1 << LBITS) - 1
FOLD = 19 << 6               # 2^(29 * 9) = 2^261 == 19 * 2^6 (mod p)


def window_bits(n: int) -> int:
    """The window width c <= MAX_C that needs the fewest point additions,
    ceil(253 / c) (n + 2^(c + 1))."""
    return min(range(1, MAX_C + 1), key=lambda c: additions(n, c))


def fewest_additions(n: int) -> int:
    """The point additions a Pippenger MSM of n points needs at its best
    window width, with no cap on c: the work a bound may count."""
    return min(additions(n, c) for c in range(1, SCALAR_BITS + 1))


def additions(n: int, c: int) -> int:
    """Point additions of a Pippenger MSM of n points on c-bit windows: n
    bucket additions and 2^(c + 1) for the running sums, per window."""
    return -(-SCALAR_BITS // c) * (n + (2 << c))


def bucket_shape(n: int, c: int) -> tuple[int, int]:
    """(blocks a window, teams a block) of the bucket kernel: each team
    takes an equal share of the window's n + 2^c events, at least
    MIN_EVENTS, and no more than it takes for all windows' teams to come
    to about TARGET_TEAMS; a window of fewer than TEAMS teams is one block
    of a power of two of them."""
    nwin, events = -(-SCALAR_BITS // c), n + (1 << c)
    per_team = max(MIN_EVENTS, -(-nwin * events // TARGET_TEAMS))
    teams = -(-events // per_team)
    if teams <= TEAMS:
        return 1, 1 << (teams - 1).bit_length()
    return -(-teams // TEAMS), TEAMS


def scratch(n: int, c: int, blocks: int, device) -> list[torch.Tensor]:
    """The kernel's scratch: digits [nwin, n] (u16), the points' cached
    forms [n, 32], idx [nwin, n], bstart [nwin, 2^c + 1], part [nwin,
    blocks, 32], win [nwin, 2, 32] (each window's sum, plain and cached)
    and sync [2 nwin + 4] (the windows' tickets and flags, then the join's
    chain and wait times)."""
    nwin = -(-SCALAR_BITS // c)
    i32 = torch.int32
    return [torch.empty((nwin, n), dtype=torch.int16, device=device),
            torch.empty((n, 32), dtype=i32, device=device),
            torch.empty((nwin, n), dtype=i32, device=device),
            torch.empty((nwin, (1 << c) + 1), dtype=i32, device=device),
            torch.empty((nwin, blocks, 32), dtype=i32, device=device),
            torch.empty((nwin, 2, 32), dtype=i32, device=device),
            torch.empty(2 * nwin + 4, dtype=i32, device=device)]


def _check(scalars: torch.Tensor, points: torch.Tensor) -> int:
    n = scalars.shape[0] if scalars.dim() == 2 else -1
    if (scalars.dtype != torch.uint8 or points.dtype != torch.uint8
            or tuple(scalars.shape) != (n, 32)
            or tuple(points.shape) != (n, 128) or n < 1):
        raise ValueError("msm takes uint8 scalars [n, 32] and points "
                         "[n, 128], n >= 1")
    if scalars.device != points.device:
        raise ValueError("scalars and points lie on different devices")
    return n


def msm(scalars: torch.Tensor, points: torch.Tensor,
        c: int | None = None) -> torch.Tensor:
    """sum_i scalars[i] * points[i] as uint8 [128]: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    n = _check(scalars, points)
    c = window_bits(n) if c is None else c
    if not 1 <= c <= MAX_C:
        raise ValueError(f"window width {c} outside [1, {MAX_C}]")
    if scalars.device.type == "cpu":
        return msm_plain(scalars, points, c)
    if scalars.device.type != "cuda":
        raise ValueError(f"unsupported device {scalars.device}")
    return _launch(scalars, points, c)[0]


def _launch(scalars: torch.Tensor, points: torch.Tensor, c: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on CUDA tensors: (out, scratch's sync)."""
    n = scalars.shape[0]
    scalars, points = scalars.contiguous(), points.contiguous()
    blocks, teams = bucket_shape(n, c)
    out = torch.empty(128, dtype=torch.uint8, device=scalars.device)
    work = scratch(n, c, blocks, scalars.device)
    _build.launch("msm", "msm", scalars, points, *work, out, n, c, blocks,
                  teams)
    _build.LAUNCHES["msm"] += 1
    return out, work[-1]


def join_times(scalars: torch.Tensor, points: torch.Tensor,
               c: int | None = None) -> tuple[float, float]:
    """One launch of `msm` on CUDA tensors and its join's times in ms, read
    from the card's globaltimer: the chain (c (nwin - 1) doublings and
    nwin - 1 additions, without its waits for windows after the top one)
    and those waits."""
    n = _check(scalars, points)
    c = window_bits(n) if c is None else c
    sync = _launch(scalars, points, c)[1]
    words = sync[-4:].cpu().numpy().astype("int64") & 0xffffffff
    return ((int(words[0]) | int(words[1]) << 32) / 1e6,
            (int(words[2]) | int(words[3]) << 32) / 1e6)


def buf_tensors(scalar_buf, point_buf, n: int, device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Marshalled scalars (32 bytes each) and points (128 bytes each, the
    layout of `native.points_to_buf`) as the uint8 tensors `msm` takes."""
    sb = torch.frombuffer(bytearray(scalar_buf), dtype=torch.uint8)
    pb = torch.frombuffer(bytearray(point_buf), dtype=torch.uint8)
    return sb.view(n, 32).to(device), pb.view(n, 128).to(device)


def to_tensors(scalars, points, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Python scalars and `cv.Point`s as the uint8 tensors `msm` takes."""
    return buf_tensors(native.scalars_to_buf(scalars, cv.L),
                       native.points_to_buf(points), len(points), device)


def point_of(out: torch.Tensor) -> cv.Point:
    """The `cv.Point` of an MSM output, its coordinates reduced mod p."""
    raw = bytes(out.cpu().numpy().tobytes())
    x, y, z, t = (int.from_bytes(raw[32 * i:32 * i + 32], "little") % P
                  for i in range(4))
    return cv.Point(x, y, z, t)


def msm_points(scalars, points, device) -> cv.Point:
    """`msm` on `device` for python scalars and `cv.Point`s."""
    return point_of(msm(*to_tensors(scalars, points, device)))


def msm_bufs(scalar_buf, point_buf, n: int, device) -> cv.Point:
    """`msm` on `device` for marshalled scalars and points."""
    return point_of(msm(*buf_tensors(scalar_buf, point_buf, n, device)))


# ---------------------------------------------------------------------------
# the plain version: the reference's 9 x 29-bit field in int64
# ---------------------------------------------------------------------------


def limbs_from_int(x: int) -> list[int]:
    x %= P
    return [(x >> (LBITS * i)) & LMASK for i in range(NLIMB)]


def int_from_limbs(v) -> int:
    """The field element of one [9] limb row (any int64 limbs)."""
    return sum(int(v[i]) << (LBITS * i) for i in range(NLIMB)) % P


def _bias() -> torch.Tensor:
    """512 p in 'fat' limbs, each >= 2^31, so that a + bias - b never goes
    negative for operand limbs below 2^31 (the reference's `_bias`)."""
    kp = 512 * P
    fat = [(kp >> (LBITS * i)) & LMASK for i in range(NLIMB - 1)]
    fat.append(kp >> (LBITS * (NLIMB - 1)))
    for i in range(NLIMB - 1, 0, -1):
        fat[i] -= 8
        fat[i - 1] += 8 << LBITS
    return torch.tensor(fat, dtype=torch.int64)


_BIAS = _bias()
_K2D = torch.tensor(limbs_from_int(2 * cv.D % P), dtype=torch.int64)
# column of each of the 81 limb products a_i b_j
_COLUMN = torch.tensor([i + j for i in range(NLIMB) for j in range(NLIMB)])


def _carry_fold(c: torch.Tensor) -> torch.Tensor:
    """Columns [..., m] (m >= 9, values < 2^62) to limbs [..., 9] below
    2^29 (limb 0 below 2^29 + 2^22): two rounds of carries and the fold of
    the columns above 2^261 by 19 * 2^6."""
    cols = list(c.movedim(-1, 0).contiguous())
    for _ in range(2):
        outs = []
        carry = 0
        for col in cols:
            cur = col + carry
            outs.append(cur & LMASK)
            carry = cur >> LBITS
        outs.append(carry)
        cols = outs[:NLIMB]
        for i, hi in enumerate(outs[NLIMB:]):
            cols[i] = cols[i] + hi * FOLD
    return torch.stack(cols, dim=-1)


def fmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply of limb tensors [..., 9] (limbs below 2^30)."""
    a, b = torch.broadcast_tensors(a, b)
    prod = (a[..., :, None] * b[..., None, :]).flatten(-2)
    cols = torch.zeros(a.shape[:-1] + (2 * NLIMB - 1,), dtype=torch.int64,
                       device=a.device)
    cols.index_add_(-1, _COLUMN.to(a.device), prod)
    return _carry_fold(cols)


def fadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry_fold(a + b)


def fsub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry_fold(a + _BIAS.to(a.device) - b)


def padd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Unified addition of extended points [..., 4, 9] (X, Y, Z, T), the
    reference's `padd`: doubles and adds the identity too."""
    x1, y1, z1, t1 = p.unbind(-2)
    x2, y2, z2, t2 = q.unbind(-2)
    a = fmul(fsub(y1, x1), fsub(y2, x2))
    b = fmul(fadd(y1, x1), fadd(y2, x2))
    c = fmul(fmul(t1, t2), _K2D.to(p.device))
    d = fmul(z1, z2)
    d = fadd(d, d)
    e, f, g, h = fsub(b, a), fsub(d, c), fadd(d, c), fadd(b, a)
    return torch.stack([fmul(e, f), fmul(g, h), fmul(f, g), fmul(e, h)],
                       dim=-2)


def identity(shape=(), device="cpu") -> torch.Tensor:
    out = torch.zeros(tuple(shape) + (4, NLIMB), dtype=torch.int64,
                      device=device)
    out[..., 1, 0] = 1
    out[..., 2, 0] = 1
    return out


def _bits(raw: torch.Tensor, nbits: int) -> torch.Tensor:
    """uint8 [..., k] little-endian to its first nbits bits, int64."""
    shifts = torch.arange(8, device=raw.device)
    bits = ((raw.to(torch.int64)[..., :, None] >> shifts) & 1).flatten(-2)
    return bits[..., :nbits]


def points_to_limbs(points: torch.Tensor) -> torch.Tensor:
    """uint8 [n, 128] to extended points [n, 4, 9] of 29-bit limbs."""
    bits = _bits(points.view(-1, 4, 32), 256)
    bits = torch.nn.functional.pad(bits, (0, NLIMB * LBITS - 256))
    weights = 1 << torch.arange(LBITS, device=points.device)
    return (bits.view(-1, 4, NLIMB, LBITS) * weights).sum(-1)


def digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """The c-bit window digits [ceil(253 / c), n] of uint8 scalars [n, 32],
    least significant window first."""
    nwin = -(-SCALAR_BITS // c)
    bits = _bits(scalars, 256)
    bits = torch.nn.functional.pad(bits, (0, max(0, nwin * c - 256)))
    bits = bits[:, :nwin * c].reshape(-1, nwin, c)
    weights = 1 << torch.arange(c, device=scalars.device)
    return (bits * weights).sum(-1).T


def key_sums(keys: torch.Tensor, pts: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, S_k) for each distinct key k, S_k the sum of the pts [m, 4, 9]
    whose keys equal k: the entries sorted by key (stably), then each key's
    run summed by a pairwise tree, its entries at even ranks adding their
    odd neighbours, level by level."""
    dev = pts.device
    keys, order = torch.sort(keys, stable=True)
    pts = pts[order]
    while keys.numel() > 1 and bool((keys[1:] == keys[:-1]).any()):
        m = keys.numel()
        pos = torch.arange(m, device=dev)
        head = torch.ones(m, dtype=torch.bool, device=dev)
        head[1:] = keys[1:] != keys[:-1]
        start = torch.cummax(torch.where(head, pos, 0), 0).values
        left = pos[(pos - start) % 2 == 0]
        nxt = torch.clamp(left + 1, max=m - 1)
        paired = (left + 1 < m) & (keys[nxt] == keys[left])
        right = torch.where(paired[:, None, None], pts[nxt],
                            identity((left.numel(),), dev))
        pts, keys = padd(pts[left], right), keys[left]
    return keys, pts


def window_sums(dig: torch.Tensor, pts: torch.Tensor, c: int
                ) -> torch.Tensor:
    """W_w = sum_b b S_{w,b} for every window [nwin, 4, 9]: the non-empty
    buckets of all windows at once (digit 0 dropped), then sum_b b S_b as
    sum_k 2^k U_k, U_k the sum of the S_b whose b has bit k set."""
    nwin, n = dig.shape
    buckets = 1 << c
    dev = pts.device
    keys = (dig + buckets * torch.arange(nwin, device=dev)[:, None]
            ).flatten()
    src = torch.arange(n, device=dev).repeat(nwin)
    keep = dig.flatten() != 0
    keys, sums = key_sums(keys[keep], pts[src[keep]])
    bit = torch.arange(c, device=dev)
    sel = ((keys % buckets)[:, None] >> bit) & 1 == 1     # [K, c]
    ukeys, usums = key_sums(
        ((keys // buckets)[:, None] * c + bit).expand(sel.shape)[sel],
        sums[:, None].expand(sel.shape + (4, NLIMB))[sel])
    u = identity((nwin * c,), dev)
    u[ukeys] = usums
    u = u.view(nwin, c, 4, NLIMB)
    acc = u[:, c - 1]
    for k in range(c - 2, -1, -1):
        acc = padd(padd(acc, acc), u[:, k])
    return acc


def msm_plain(scalars: torch.Tensor, points: torch.Tensor, c: int
              ) -> torch.Tensor:
    """The plain version of `msm` (uint8 [128], coordinates below p)."""
    wins = window_sums(digits(scalars, c), points_to_limbs(points), c)
    rows = wins.cpu().tolist()
    pts = [cv.Point(*(int_from_limbs(coord) for coord in w)) for w in rows]
    acc = pts[-1]
    for w in reversed(pts[:-1]):
        for _ in range(c):
            acc = acc.double()
        acc = acc + w
    raw = native.points_to_buf([acc])
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(
        scalars.device)
