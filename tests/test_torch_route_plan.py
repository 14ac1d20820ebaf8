"""The MoE route kernel's slot algorithm and launch plan, held on the CPU.

``route_slots_segmented`` is the slot kernel's algorithm in PyTorch: the
pairs in flat (t, k) order cut into segments, each segment's pairs counted
per expert, an exclusive scan over the segments, and each pair's rank in
its segment. It must give exactly the slots of the serial rank that
``route_from_logits_plain`` and the JAX dispatch (the stable ``argsort``
+ ``searchsorted`` of ``src/repro/models/moe.py:88-97``) give, whatever
the segment length, with forced drops and tied logits, at the shapes of
phi3.5-moe-42b-a6.6b (E 16, K 2) and kimi-k2-1t-a32b (E 384, K 8).
Everything here is integer work: exact equality, no tolerance.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import moe

SHAPES = {"phi3.5-moe": (16, 2), "kimi-k2": (384, 8)}


def _jax_slots(experts: np.ndarray, C: int):
    """The JAX dispatch's slot and keep of each pair, in flat order."""
    flat = jnp.asarray(experts.reshape(-1))
    order = jnp.argsort(flat)                          # stable
    sorted_e = flat[order]
    first = jnp.searchsorted(sorted_e, sorted_e, side="left")
    slot_sorted = jnp.arange(flat.shape[0]) - first
    slot = np.empty(flat.shape[0], np.int64)
    slot[np.asarray(order)] = np.asarray(slot_sorted)
    return slot, slot < C


def _segments(P: int):
    """Segment lengths to try: the kernel's own (a multiple of 32), one
    pair, a ragged 37 and all the pairs in one segment."""
    return sorted({moe.route_segment(P), 1, 37, P})


def _check(experts: torch.Tensor, logits: torch.Tensor, E: int, K: int,
           C: int, pin: bool = False):
    """route_slots_segmented at every segment length == the plain routing
    of the same experts == the JAX dispatch."""
    _, ep, sp, cp, srcp, _ = moe.route_from_logits_plain(
        logits, K, C, experts=experts if pin else None)
    assert torch.equal(ep, experts.to(torch.int32))
    kept = torch.arange(C)[None] < cp[:, None]
    slot_j, keep_j = _jax_slots(experts.numpy(), C)
    np.testing.assert_array_equal(sp.reshape(-1).numpy(), slot_j)
    np.testing.assert_array_equal((sp < C).reshape(-1).numpy(), keep_j)
    for seg in _segments(experts.numel()):
        s, c, src = moe.route_slots_segmented(experts, E, C, seg)
        assert torch.equal(s, sp), seg
        assert torch.equal(c, cp), seg
        assert torch.equal(src[kept], srcp[kept]), seg
    return int((sp >= C).sum())


@pytest.mark.parametrize("T", [1, 4, 33, 2048])
@pytest.mark.parametrize("arch", sorted(SHAPES))
def test_segmented_slots_equal_plain_and_jax(arch, T):
    E, K = SHAPES[arch]
    rng = np.random.default_rng(26 + T)
    logits = torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32))
    C = moe.capacity(E, K, 1.25, T)
    experts = torch.sort(logits, dim=-1, descending=True,
                         stable=True).indices[:, :K]
    # the JAX top-k on the softmax probabilities picks the same experts
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy()), -1),
                            K)
    np.testing.assert_array_equal(np.asarray(jidx), experts.numpy())
    _check(experts, logits, E, K, C)


@pytest.mark.parametrize("arch", sorted(SHAPES))
def test_every_pair_to_one_expert_drops_past_capacity(arch):
    """Every pair of 2048 tokens routed to expert 3: its slots run to
    T K - 1, the pairs past C drop, every other expert's count is 0."""
    E, K = SHAPES[arch]
    T = 2048
    C = moe.capacity(E, K, 1.25, T)
    experts = torch.full((T, K), 3, dtype=torch.long)
    logits = torch.zeros((T, E))
    dropped = _check(experts, logits, E, K, C, pin=True)
    assert dropped == T * K - C
    _, counts, _ = moe.route_slots_segmented(experts, E, C,
                                             moe.route_segment(T * K))
    assert counts[3] == C and int(counts.sum()) == C


@pytest.mark.parametrize("arch", sorted(SHAPES))
def test_tied_logits(arch):
    """Logits drawn from four values, so most tokens tie across the
    top-K edge: the lower expert ids win, as the JAX top-k orders them,
    and the slots still equal the serial rank."""
    E, K = SHAPES[arch]
    T = 2048
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.integers(0, 4, (T, E)).astype(np.float32))
    C = moe.capacity(E, K, 1.25, T)
    experts = torch.sort(logits, dim=-1, descending=True,
                         stable=True).indices[:, :K]
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy()), -1),
                            K)
    np.testing.assert_array_equal(np.asarray(jidx), experts.numpy())
    assert _check(experts, logits, E, K, C) > 0      # the low ids overflow


def test_route_launches_reads_only_its_arguments():
    assert list(inspect.signature(moe.route_launches).parameters) == [
        "T", "D", "E", "K"]
    for D, (E, K) in ((4096, SHAPES["phi3.5-moe"]),
                      (7168, SHAPES["kimi-k2"]), (520, (8, 2)), (64, (32, 2)),
                      (64, (40, 2)), (7168, (1024, 8))):
        one = moe.ROUTE_CLUSTER_T if E <= 32 else moe.ROUTE_CLUSTER_T_WIDE
        for T in range(1, one + 1):
            assert moe.route_launches(T, D, E, K) == 1
        for T in (one + 1, 17, 64, 333, 512, 2048):
            assert moe.route_launches(T, D, E, K) == 3
    assert moe.ROUTE_CLUSTER_T == 16 and moe.ROUTE_CLUSTER_T_WIDE == 4


def test_segment_covers_pairs_in_32_segments():
    """The slot kernel's 32 warps hold every pair: a segment is a
    multiple of 32 pairs, the least of them that 32 segments cover."""
    for P in (1, 2, 8, 31, 32, 33, 1024, 1025, 4096, 16384, 24576):
        seg = moe.route_segment(P)
        assert seg % 32 == 0 and seg > 0
        assert moe.ROUTE_SEGMENTS * seg >= P
        assert moe.ROUTE_SEGMENTS * (seg - 32) < P
