"""The mixture-of-experts FFN's kernels: routing, the grouped expert GEMMs
and the combine (``csrc/moe.cu``).

No Pallas kernel of the JAX package stands behind them: its
``models/moe.py::moe_forward`` computes the MoE FFN with ``jnp.einsum``
outside any kernel, each expert GEMM one batched einsum over all E
experts padded to the capacity C, so that every step streams every
expert's weights. These kernels compute the same function and skip what
is never gathered back: experts no token was routed to, and rows past
each expert's count. The design of each is described in the source.

- ``moe_route(x, w, K, C, reads)``: the router's f32 logits (T, E) of
  x (T, D) and its weight w (D, E), each product exact in f32 and summed
  in one order planned from (D, E) alone (a token's logits do not depend
  on T), then gates (T, K) f32, experts (T, K), slots (T, K), counts (E,)
  and the gather map (E, C), all int32, and the logits. The top K are
  chosen on the logits, which orders them as ``jax.lax.top_k`` orders the
  softmax probabilities (equal values to the lower expert id); the gates
  are their probabilities divided by ``max(sum, 1e-9)`` (the kernel
  cancels the softmax's denominator: exp(l - l_max) over the chosen
  ones' sum, a rounding or two apart); a pair's slot is
  its rank among the pairs of its expert in flat (t, k) order, the stable
  ``argsort`` + ``searchsorted`` of the JAX dispatch; a pair is kept
  where its slot < C; counts[e] = min(pairs of e, C), and the map holds
  the token of each kept (e, slot). Where ``reads`` (an int64 (2,)
  tensor, ``Model.expert_reads``) is given, it adds the number of
  experts with a pair and one layer pass to it. On the card a call is
  ``route_launches(T, D, E, K)`` launches: one of clusters of CTAs at a
  megastep's decode T (up to ``ROUTE_CLUSTER_T``, or
  ``ROUTE_CLUSTER_T_WIDE`` past 32 experts), else a tiled router
  product, a top-k kernel and
  a slot kernel whose warps rank fixed segments of the pairs
  (``route_slots_segmented`` is that algorithm in PyTorch).
- ``moe_gate_up_swiglu(a, w, C, counts, src)``: h (G, C, F) =
  silu(g) * u of the f32 sums rows @ w (G, D, 2F), rounded once, for the
  rows c < counts[g] of each group g, its row c being a[src[g, c]] (or
  a[g * C + c] without ``src``); other rows are not written.
- ``moe_down(h, w, counts)``: y (G, C, D) = rows @ w (G, F, D) in f32,
  rounded once, over the same rows.
- ``moe_combine(y, gates, experts, slots, shared)``: out (T, D) = the
  gate-weighted sum over k, in k order, of f32(y[e, slot]) (0 for a
  dropped pair), rounded once, then + ``shared`` in the output dtype.
- ``moe_down_combine(h, w, gates, experts, slots, counts, shared)``: the
  two above at decode (``moe_down_combined(C)``), with their bits: the
  down GEMM writes its f32 sums by chunk and one kernel adds them, rounds
  y and combines, so y never reaches device memory.

The shared experts (kimi-k2) run through the two GEMMs as one group of T
rows with no counts and no map, so they round where the JAX MoE rounds
them (moe.py:128-139). The GEMMs' tiling is set here, in plain
functions the CPU tests hold: the row tile (``row_tile``), the chunks of
K (``moe_gemm_plan``, from K, the weight width and the SM count alone),
the route (``moe_gemm_split``), the gathering of mapped rows
(``moe_gemm_gathers``), the persistent grid (``moe_gemm_ctas``) and
the decode's down + combine (``moe_down_combined``).
Each ``*_plain`` function is the plain PyTorch version with the same
rounding points (an f32 product of the operands, one cast), looping over
the experts that have rows; each wrapper runs it for CPU tensors only,
and for a CUDA tensor launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.tickets import tickets

MAX_K = 8                      # experts a token the route kernel takes
MAX_EXPERTS = 1024
ROUTE_CLUSTER_T = 16           # the largest T the one-launch (cluster) route takes at E <= 32
ROUTE_CLUSTER_T_WIDE = 4       # and above (kimi-k2's E 384: three launches are faster at T 16)
ROUTE_SEGMENTS = 32            # the slot kernel's warps, a segment of pairs each

_P, _I = ctypes.c_void_p, ctypes.c_int
_ROUTE_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
               _P)
_GEMM_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)
_COMBINE_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
_DOWN_COMBINE_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _I, _P)

Route = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor, torch.Tensor]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(what: str, *tensors: Optional[torch.Tensor]) -> None:
    dev = next(t for t in tensors if t is not None).device
    for t in tensors:
        if t is None:
            continue
        _require(t.is_cuda and t.device == dev,
                 f"{what}: all inputs must be on one CUDA device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 f"{what}: inputs must be contiguous and 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def capacity(num_experts: int, experts_per_token: int,
             capacity_factor: float, n_tokens: int) -> int:
    """Rows a expert keeps of a call of ``n_tokens`` tokens: the JAX
    ``moe.capacity``, at least 8 and a multiple of 8."""
    c = int(math.ceil(n_tokens * experts_per_token * capacity_factor
                      / num_experts))
    return max(8, ((c + 7) // 8) * 8)


# -- routing ------------------------------------------------------------------
def router_logits_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The router's f32 logits, ``x.float() @ w.float()`` (the JAX
    einsum at moe.py:74)."""
    return torch.matmul(x.float(), w.float())


def route_from_logits_plain(logits: torch.Tensor, K: int, C: int,
                            reads: Optional[torch.Tensor] = None,
                            experts: Optional[torch.Tensor] = None) -> Route:
    """The routing of these f32 logits (T, E): the route kernel's second
    launch, in plain PyTorch; the logits are returned as given. Given
    ``experts`` (T, K), it routes to those instead of choosing its own
    (a check that compares two passes through a model pins the second
    pass to the first's choice)."""
    T, E = logits.shape
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    if experts is None:
        experts = torch.sort(logits, dim=-1, descending=True,
                             stable=True).indices[:, :K]
    experts = experts.long()
    gates = probs.gather(1, experts)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    slots = torch.empty_like(flat)
    slots[order] = torch.arange(flat.numel(), device=dev) - first
    n_pairs = torch.bincount(flat, minlength=E)
    counts = torch.clamp(n_pairs, max=C).to(torch.int32)
    src = torch.zeros((E, C), dtype=torch.int32, device=dev)
    keep = slots < C
    tokens = torch.arange(T, device=dev).repeat_interleave(K)
    src[flat[keep], slots[keep]] = tokens[keep].to(torch.int32)
    if reads is not None:
        reads[0] += int((n_pairs > 0).sum())
        reads[1] += 1
    return (gates, experts.to(torch.int32), slots.view(T, K).to(torch.int32),
            counts, src, logits)


def moe_route_plain(x: torch.Tensor, w: torch.Tensor, K: int, C: int,
                    reads: Optional[torch.Tensor] = None) -> Route:
    return route_from_logits_plain(router_logits_plain(x, w), K, C, reads)


def route_launches(T: int, D: int, E: int, K: int) -> int:
    """The kernel launches of one ``moe_route`` call on the card: one (of
    clusters of CTAs) at T <= ``ROUTE_CLUSTER_T`` for E <= 32 (the tokens
    of a decode step) or T <= ``ROUTE_CLUSTER_T_WIDE`` for more experts,
    else the tiled router, the top-k and the slot kernel. D and K do not
    change it."""
    one = ROUTE_CLUSTER_T if E <= 32 else ROUTE_CLUSTER_T_WIDE
    return 1 if T <= one else 3


def route_segment(P: int) -> int:
    """The slot kernel's segment of pairs a warp: 32 x n pairs, n from the
    number of pairs P alone, the least that lets ``ROUTE_SEGMENTS``
    segments hold them."""
    return 32 * -(-P // (32 * ROUTE_SEGMENTS))


def route_slots_segmented(experts: torch.Tensor, E: int, C: int,
                          seg: int) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The slot kernel's algorithm in plain PyTorch: experts (T, K) in
    flat (t, k) order cut into segments of ``seg`` pairs; each segment's
    pairs counted per expert, an exclusive scan over the segments giving
    each (segment, expert) its first slot, and a pair's slot that plus
    its rank among the earlier pairs of its expert in its segment. The
    slots do not depend on ``seg``. → (slots (T, K), counts (E,), src
    (E, C)) int32, as ``route_from_logits_plain`` gives them (the map's
    entries past a count 0)."""
    T, K = experts.shape
    flat = experts.reshape(-1).long()
    P = flat.numel()
    segs = max(1, -(-P // seg))
    seg_of = torch.arange(P, device=flat.device) // seg
    onehot = F.one_hot(flat, E)                          # (P, E)
    per_seg = torch.zeros((segs, E), dtype=torch.long, device=flat.device)
    per_seg.index_add_(0, seg_of, onehot)
    first = torch.cumsum(per_seg, 0) - per_seg           # exclusive over segments
    # a pair's rank among the earlier pairs of its expert in its segment
    # (the warp's __match_any_sync ranks and running counts)
    key = seg_of * E + flat
    order = torch.argsort(key, stable=True)
    sk = key[order]
    rank = torch.empty_like(flat)
    rank[order] = (torch.arange(P, device=flat.device)
                   - torch.searchsorted(sk, sk, side="left"))
    slots = first[seg_of, flat] + rank
    n_pairs = per_seg.sum(0)
    counts = torch.clamp(n_pairs, max=C).to(torch.int32)
    src = torch.zeros((E, C), dtype=torch.int32, device=flat.device)
    keep = slots < C
    tokens = torch.arange(T, device=flat.device).repeat_interleave(K)
    src[flat[keep], slots[keep]] = tokens[keep].to(torch.int32)
    return slots.view(T, K).to(torch.int32), counts, src


def moe_route(x: torch.Tensor, w: torch.Tensor, K: int, C: int,
              reads: Optional[torch.Tensor] = None) -> Route:
    """x (T, D), the router weight w (D, E) → (gates (T, K) f32, experts
    (T, K), slots (T, K), counts (E,), src (E, C), logits (T, E) f32),
    the int32 tensors described above (the map's rows past a count are
    not written)."""
    (T, D), E = x.shape, w.shape[1]
    _require(w.shape[0] == D, f"moe_route: x {tuple(x.shape)} against the "
             f"router {tuple(w.shape)}")
    _require(1 <= K <= min(E, MAX_K) and E <= MAX_EXPERTS,
             f"moe_route: top-{K} of {E} experts (K <= {MAX_K}, "
             f"E <= {MAX_EXPERTS})")
    if x.device.type == "cpu":
        return moe_route_plain(x, w, K, C, reads)
    _require(x.dtype == w.dtype == torch.bfloat16 and E % 8 == 0
             and D % 8 == 0 and C >= 1,
             f"moe_route kernel takes bf16 x and router weights, E and D "
             f"multiples of 8 and C >= 1, got {x.dtype}, {w.dtype}, E {E}, "
             f"D {D}, C {C}")
    _check_cuda("moe_route", x, w, reads)
    dev = x.device
    logits = torch.empty((T, E), dtype=torch.float32, device=dev)
    gates = torch.empty((T, K), dtype=torch.float32, device=dev)
    experts, slots = (torch.empty((T, K), dtype=torch.int32, device=dev)
                      for _ in range(2))
    counts = torch.empty((E,), dtype=torch.int32, device=dev)
    src = torch.empty((E, C), dtype=torch.int32, device=dev)
    launches = route_launches(T, D, E, K)
    # one cluster takes 16 experts (two blocks of 8) or more; past 16 the
    # one-launch route may need more clusters, and so their ticket (the
    # first of the stream's counts, which its last leader wraps to 0)
    ticket = tickets(1, x.device) if launches == 1 and E > 16 else None
    fn = build.function("moe", "moe_route", _ROUTE_ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), logits.data_ptr(), T, D, E, K, C,
             gates.data_ptr(), experts.data_ptr(), slots.data_ptr(),
             counts.data_ptr(), src.data_ptr(), _ptr(reads), _ptr(ticket),
             launches, _stream(x))
    build.check(err, "moe_route")
    moe_route.launches += 1
    return gates, experts, slots, counts, src, logits


moe_route.launches = 0


# -- the grouped expert GEMMs -------------------------------------------------
def _group_rows(counts: Optional[torch.Tensor], G: int, C: int):
    """(group, rows) for each group with rows (all C without counts)."""
    if counts is None:
        return [(g, C) for g in range(G)]
    return [(g, n) for g, n in enumerate(counts.tolist()) if n > 0]


def _out(out: Optional[torch.Tensor], shape, like: torch.Tensor, what: str
         ) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    _require(tuple(out.shape) == tuple(shape) and out.dtype == like.dtype,
             f"{what}: out is {tuple(out.shape)} {out.dtype}, not "
             f"{tuple(shape)} {like.dtype}")
    return out


def moe_gate_up_swiglu_plain(a: torch.Tensor, w: torch.Tensor, C: int,
                             counts: Optional[torch.Tensor] = None,
                             src: Optional[torch.Tensor] = None,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    G, _, F2 = w.shape
    Fw = F2 // 2
    out = _out(out, (G, C, Fw), a, "moe_gate_up_swiglu")
    for g, n in _group_rows(counts, G, C):
        rows = a[src[g, :n].long()] if src is not None else \
            a[g * C:g * C + n]
        gu = torch.matmul(rows.float(), w[g].float())
        out[g, :n] = (F.silu(gu[:, :Fw]) * gu[:, Fw:]).to(a.dtype)
    return out


def moe_down_plain(h: torch.Tensor, w: torch.Tensor,
                   counts: Optional[torch.Tensor] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    G, C, _ = h.shape
    out = _out(out, (G, C, w.shape[2]), h, "moe_down")
    for g, n in _group_rows(counts, G, C):
        out[g, :n] = torch.matmul(h[g, :n].float(),
                                  w[g].float()).to(h.dtype)
    return out


K_TILE = 64                   # k rows a stage of the GEMM ring
COL_BLOCK = 128               # weight columns a work item (GLU: 64 gate + 64 up)
ROW_TILES = (16, 128)         # the kernel's instances (wgmma's N)


def row_tile(C: int) -> int:
    """The GEMM's row tile for capacity C: 16 rows at decode (C <= 16),
    else 128 (phi3.5-moe's 4 x 512 bucket, C 320, is three tiles, the
    third empty for an expert of 256 rows or fewer)."""
    return ROW_TILES[0] if C <= ROW_TILES[0] else ROW_TILES[1]


def moe_gemm_plan(K: int, N: int, sms: int) -> Tuple[int, int]:
    """(chunks, k_per_chunk): K cut into chunks of ``k_per_chunk`` rows,
    a multiple of ``K_TILE`` (the last chunk holds the rest), so that two
    active experts give at least ``sms`` work items of ``COL_BLOCK`` of
    the N weight columns each. It depends on (K, N, sms) alone, never on
    the counts, C, the active experts or the row tile, so a row's sums do
    not depend on its batch-mates' routing."""
    blocks = -(-N // COL_BLOCK)
    k_tiles = -(-K // K_TILE)
    want = min(k_tiles, max(1, -(-sms // (2 * blocks))))
    per = -(-k_tiles // want) * K_TILE
    return -(-K // per), per


def moe_gemm_gathers(C: int, mapped: bool) -> bool:
    """Rows through the map are gathered by a first kernel into (G, C, K)
    past the 16-row tile (prefill), so that the GEMM loads them as TMA
    boxes; at the 16-row tile the GEMM copies them itself, a row a copy."""
    return mapped and C > ROW_TILES[0]


def moe_gemm_split(C: int, chunks: int) -> bool:
    """The split route: one row tile a group and more than one chunk, so
    each chunk is a work item whose f32 sums a second kernel adds in
    chunk order (two launches a call); else an item walks the chunks and
    adds them in the same order itself (one launch)."""
    return chunks > 1 and C <= row_tile(C)


def moe_down_combined(C: int) -> bool:
    """Whether ``moe_down`` and ``moe_combine`` run as one kernel pair
    (``moe_down_combine``): at decode, C within the 16-row tile, the down
    GEMM writes its f32 sums by chunk (one chunk or more) and one kernel
    adds them and combines, so y is never written; the prefill's C takes
    the two apart."""
    return C <= ROW_TILES[0]


def moe_gemm_ctas(G: int, C: int, N: int, chunks: int, sms: int) -> int:
    """The persistent grid: the call's work items (all groups counted),
    at most two CTAs an SM at the 16-row tile and one past it."""
    R = row_tile(C)
    items = (G * -(-C // R) * -(-N // COL_BLOCK)
             * (chunks if moe_gemm_split(C, chunks) else 1))
    return min(items, sms * (2 if R == ROW_TILES[0] else 1))


_SMS = {}


def _sms(dev: torch.device) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


DOWN_COMBINE_LAUNCHES = 2      # the down GEMM and moe_down_combine_kernel


def gemm_launches(w: torch.Tensor, C: int, mapped: bool = False) -> int:
    """Kernels a GEMM wrapper launches for w (G, K, N') on its device at
    capacity C, rows through a map or not: the GEMM, one more on the
    split route, one more where the rows are gathered first."""
    chunks, _ = moe_gemm_plan(w.shape[1], w.shape[2], _sms(w.device))
    return (1 + moe_gemm_split(C, chunks)
            + moe_gemm_gathers(C, mapped))


def _gemm(what: str, glu: int, a: torch.Tensor, src: Optional[torch.Tensor],
          w: torch.Tensor, counts: Optional[torch.Tensor], out: torch.Tensor,
          C: int, N: int) -> None:
    G, K, Nw = w.shape
    _require(a.dtype == w.dtype == torch.bfloat16,
             f"{what} kernel takes bf16 rows and weights, got {a.dtype}, "
             f"{w.dtype}")
    _require(K % 8 == 0 and N % 8 == 0,
             f"{what}: K {K} and N {N} must be multiples of 8")
    _require(G <= MAX_EXPERTS, f"{what}: {G} groups (at most {MAX_EXPERTS})")
    for t in (counts, src):
        _require(t is None or t.dtype == torch.int32,
                 f"{what}: counts and the map are int32")
    _check_cuda(what, a, src, w, counts, out)
    if G == 0 or C == 0:
        return
    sms = _sms(w.device)
    chunks, kper = moe_gemm_plan(K, Nw, sms)
    partial = gathered = None
    if moe_gemm_split(C, chunks):
        partial = torch.empty((chunks, G, C, Nw), dtype=torch.float32,
                              device=w.device)
    if moe_gemm_gathers(C, src is not None):
        _require(counts is not None, f"{what}: a map needs the counts")
        gathered = torch.empty((G, C, K), dtype=a.dtype, device=a.device)
    fn = build.function("moe", "moe_gemm", _GEMM_ARGS)
    err = fn(glu, a.data_ptr(), _ptr(src), w.data_ptr(), _ptr(counts),
             out.data_ptr(), _ptr(partial), _ptr(gathered), G, C, K, N,
             a.numel() // K, row_tile(C), kper,
             moe_gemm_ctas(G, C, Nw, chunks, sms), _stream(a))
    build.check(err, what)


def moe_gate_up_swiglu(a: torch.Tensor, w: torch.Tensor, C: int,
                       counts: Optional[torch.Tensor] = None,
                       src: Optional[torch.Tensor] = None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a (R, D), w (G, D, 2F) → h (G, C, F) in a's dtype; rows past a
    group's count (and whole groups of count 0) are left as they are in
    ``out`` (uninitialized when it is not given)."""
    G, D, F2 = w.shape
    _require(a.shape[-1] == D and F2 % 2 == 0,
             f"moe_gate_up_swiglu: rows of {a.shape[-1]} against w "
             f"{tuple(w.shape)}")
    _require(src is not None or a.shape[0] >= G * C,
             f"moe_gate_up_swiglu: {a.shape[0]} rows for {G} x {C}")
    if a.device.type == "cpu":
        return moe_gate_up_swiglu_plain(a, w, C, counts, src, out)
    out = _out(out, (G, C, F2 // 2), a, "moe_gate_up_swiglu")
    _gemm("moe_gate_up_swiglu", 1, a, src, w, counts, out, C, F2 // 2)
    moe_gate_up_swiglu.launches += 1
    return out


moe_gate_up_swiglu.launches = 0


def moe_down(h: torch.Tensor, w: torch.Tensor,
             counts: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h (G, C, F), w (G, F, D) → y (G, C, D) in h's dtype, over the rows
    c < counts[g] (all without counts); other rows are left as they are."""
    G, C, Fw = h.shape
    _require(w.shape[0] == G and w.shape[1] == Fw,
             f"moe_down: h {tuple(h.shape)} against w {tuple(w.shape)}")
    if h.device.type == "cpu":
        return moe_down_plain(h, w, counts, out)
    out = _out(out, (G, C, w.shape[2]), h, "moe_down")
    _gemm("moe_down", 0, h, None, w, counts, out, C, w.shape[2])
    moe_down.launches += 1
    return out


moe_down.launches = 0


# -- combine ------------------------------------------------------------------
def moe_combine_plain(y: torch.Tensor, gates: torch.Tensor,
                      experts: torch.Tensor, slots: torch.Tensor,
                      shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    E, C, D = y.shape
    keep = slots < C
    acc = None
    for k in range(gates.shape[1]):
        yk = y[experts[:, k].long(), torch.clamp(slots[:, k], max=C - 1).long()]
        term = torch.where(keep[:, k, None], yk.float(), 0.0) * gates[:, k, None]
        acc = term if acc is None else acc + term
    out = acc.to(y.dtype)
    return out if shared is None else out + shared


def moe_combine(y: torch.Tensor, gates: torch.Tensor, experts: torch.Tensor,
                slots: torch.Tensor,
                shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y (E, C, D), gates (T, K) f32, experts and slots (T, K) int32,
    shared (T, D) or None → out (T, D) in y's dtype."""
    E, C, D = y.shape
    T, K = gates.shape
    _require(experts.shape == slots.shape == (T, K),
             f"moe_combine: gates {tuple(gates.shape)}, experts "
             f"{tuple(experts.shape)}, slots {tuple(slots.shape)}")
    if shared is not None:
        _require(tuple(shared.shape) == (T, D),
                 f"moe_combine: shared {tuple(shared.shape)} for ({T}, {D})")
    if y.device.type == "cpu":
        return moe_combine_plain(y, gates, experts, slots, shared)
    _require(y.dtype == torch.bfloat16 and gates.dtype == torch.float32
             and (shared is None or shared.dtype == torch.bfloat16),
             "moe_combine kernel takes bf16 y and shared, f32 gates")
    _require(experts.dtype == slots.dtype == torch.int32,
             "moe_combine: experts and slots are int32")
    _require(D % 8 == 0, f"moe_combine: D {D} is not a multiple of 8")
    _check_cuda("moe_combine", y, gates, experts, slots, shared)
    out = torch.empty((T, D), dtype=y.dtype, device=y.device)
    if T == 0:
        return out
    fn = build.function("moe", "moe_combine", _COMBINE_ARGS)
    err = fn(y.data_ptr(), gates.data_ptr(), experts.data_ptr(),
             slots.data_ptr(), _ptr(shared), out.data_ptr(), T, K, C, D,
             _stream(y))
    build.check(err, "moe_combine")
    moe_combine.launches += 1
    return out


moe_combine.launches = 0


# -- down + combine at decode -------------------------------------------------
def moe_down_combine_plain(h: torch.Tensor, w: torch.Tensor,
                           gates: torch.Tensor, experts: torch.Tensor,
                           slots: torch.Tensor,
                           counts: Optional[torch.Tensor] = None,
                           shared: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``moe_combine_plain(moe_down_plain(h, w, counts), ...)``."""
    return moe_combine_plain(moe_down_plain(h, w, counts), gates, experts,
                             slots, shared)


def moe_down_combine(h: torch.Tensor, w: torch.Tensor, gates: torch.Tensor,
                     experts: torch.Tensor, slots: torch.Tensor,
                     counts: Optional[torch.Tensor] = None,
                     shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``moe_combine(moe_down(h, w, counts), gates, experts, slots,
    shared)`` at decode (``moe_down_combined(C)``): h (G, C, F), w
    (G, F, D) → out (T, D) in h's dtype, with the same bits; on the card
    the down GEMM writes its f32 sums by chunk and
    ``moe_down_combine_kernel`` adds them, rounds y and combines in one
    pass (``DOWN_COMBINE_LAUNCHES`` launches; y is never written)."""
    G, C, Fw = h.shape
    T, K = gates.shape
    _require(w.shape[0] == G and w.shape[1] == Fw,
             f"moe_down_combine: h {tuple(h.shape)} against w "
             f"{tuple(w.shape)}")
    _require(experts.shape == slots.shape == (T, K),
             f"moe_down_combine: gates {tuple(gates.shape)}, experts "
             f"{tuple(experts.shape)}, slots {tuple(slots.shape)}")
    D = w.shape[2]
    if shared is not None:
        _require(tuple(shared.shape) == (T, D),
                 f"moe_down_combine: shared {tuple(shared.shape)} for "
                 f"({T}, {D})")
    if h.device.type == "cpu":
        return moe_down_combine_plain(h, w, gates, experts, slots, counts,
                                      shared)
    _require(moe_down_combined(C), f"moe_down_combine: capacity {C} is "
             f"past the {ROW_TILES[0]}-row tile (moe_down_combined)")
    _require(h.dtype == w.dtype == torch.bfloat16
             and gates.dtype == torch.float32
             and (shared is None or shared.dtype == torch.bfloat16),
             "moe_down_combine kernel takes bf16 h, w and shared, f32 gates")
    _require(experts.dtype == slots.dtype == torch.int32
             and (counts is None or counts.dtype == torch.int32),
             "moe_down_combine: experts, slots and counts are int32")
    _require(Fw % 8 == 0 and D % 8 == 0 and 0 < K <= MAX_K,
             f"moe_down_combine: F {Fw} and D {D} must be multiples of 8, "
             f"K {K} within {MAX_K}")
    _require(G <= MAX_EXPERTS, f"moe_down_combine: {G} groups (at most "
             f"{MAX_EXPERTS})")
    _check_cuda("moe_down_combine", h, w, gates, experts, slots, counts,
                shared)
    out = torch.empty((T, D), dtype=h.dtype, device=h.device)
    if T == 0:
        return out
    sms = _sms(w.device)
    chunks, kper = moe_gemm_plan(Fw, D, sms)
    partial = torch.empty((chunks, G, C, D), dtype=torch.float32,
                          device=w.device)
    fn = build.function("moe", "moe_down_combine", _DOWN_COMBINE_ARGS)
    err = fn(h.data_ptr(), w.data_ptr(), _ptr(counts), gates.data_ptr(),
             experts.data_ptr(), slots.data_ptr(), _ptr(shared),
             out.data_ptr(), partial.data_ptr(), G, C, Fw, D, T, K, kper,
             moe_gemm_ctas(G, C, D, chunks, sms), _stream(h))
    build.check(err, "moe_down_combine")
    moe_down_combine.launches += 1
    return out


moe_down_combine.launches = 0
