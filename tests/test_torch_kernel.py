"""The CUDA kernels (greedy assignment, shortlist selection, shortlist
scan, port insertion, caps scan, the dense auction and the bid-shortlist
auction; the selection and scan also in their tenant-lane form) against
their plain PyTorch versions,
the step's host syncs, and the preemption op (PyTorch ops) cuda = cpu
on the card.

This file imports neither jax nor minisched_tpu, so it also runs on a
machine that has only the port's dependencies. The card tests skip
without a CUDA device; on the card:

    python -m pytest --noconftest -m card tests/test_torch_kernel.py
"""
import numpy as np
import pytest
import torch

from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops import residency as RES
from minisched_tpu_torch.ops import select as S
from minisched_tpu_torch.ops._cuda_build import LAUNCHES
from minisched_tpu_torch.ops.auction import auction_assign_plain
from minisched_tpu_torch.ops.auction_kernel import (auction_cuda,
                                                    bid_auction_cuda)
from minisched_tpu_torch.ops.bid_select import (
    auction_assign_shortlist, auction_assign_shortlist_plain)
from minisched_tpu_torch.ops.greedy_kernel import greedy_assign_cuda
from minisched_tpu_torch.ops.ports_kernel import insert_ports_cuda
from minisched_tpu_torch.ops.select_kernel import (
    shortlist_select_cuda, shortlist_select_lanes_cuda)
from minisched_tpu_torch.ops.shortlist_kernel import (
    shortlist_scan_cuda, shortlist_scan_lanes_cuda)
from minisched_tpu_torch.ops.caps_kernel import caps_scan_cuda
from torch_parity import (AUCTION_CASES, AUCTION_SELECT_CASES, CAPS_KINDS,
                          GREEDY_SHAPES, NEG, PORTS_DESIGN_KINDS,
                          SELECT_CARD_LIST_KINDS, SHORTLIST_CASES,
                          auction_adversarial, auction_select_case,
                          auction_fold_case, auction_strength_case,
                          auction_tie_case, bits_equal, caps_problem,
                          greedy_case, ports_case, ports_design_case,
                          scarce_case, select_list_case, shortlist_case)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        greedy_assign_cuda(torch.zeros((2, 3)), torch.zeros((2, 4)),
                           torch.zeros((3, 4)), 0)
    with pytest.raises(ValueError, match="CUDA"):
        shortlist_scan_cuda(torch.zeros((2, 3)),
                            torch.zeros((2, 1), dtype=torch.int32),
                            torch.zeros(2), torch.zeros(2),
                            torch.zeros((2, 4)), torch.zeros((3, 4)), 0)
    with pytest.raises(ValueError, match="CUDA"):
        insert_ports_cuda(*(torch.zeros(shape, dtype=torch.int32)
                            for shape in ((3, 8), (2,), (2, 4))))
    with pytest.raises(ValueError, match="CUDA"):
        shortlist_select_cuda(torch.zeros((2, 3)), 0, 2)


def test_shortlist_and_ports_on_cpu_take_the_plain_versions():
    rng = np.random.default_rng(1)
    args = [torch.from_numpy(a) for a in shortlist_case(32, 100, 3, 1)]
    n0 = dict(LAUNCHES)
    got = S.greedy_assign_shortlist(*args, 77, k=4)
    cand, kth, kthn = S.shortlist_select(args[0], 77, 4)
    want = S.greedy_assign_shortlist_plain(*args, 77, cand, kth, kthn)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    state, rows, ports = ports_case(rng)
    assert torch.equal(RES.insert_ports(torch.from_numpy(state), rows, ports),
                       RES.insert_ports_plain(*(torch.from_numpy(a) for a in
                                                (state, rows, ports))))
    assert LAUNCHES == n0


def test_dispatch_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a) for a in greedy_case(rng, 16, 128)]
    n0 = LAUNCHES["greedy_assign"]
    got = S.greedy_assign(*args, 12345)
    want = S.greedy_assign_plain(*args, 12345)
    assert LAUNCHES["greedy_assign"] == n0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("P,N,cpu_free", GREEDY_SHAPES)
def test_kernel_matches_plain_on_card(P, N, cpu_free):
    _need_card()
    rng = np.random.default_rng(P * 7 + N)
    args = [torch.from_numpy(a)
            for a in greedy_case(rng, P, N, cpu_free=cpu_free)]
    seed = prng.bits(prng.fold_in(prng.PRNGKey(3), P))
    plain = S.greedy_assign_plain(*args, seed)
    n0 = LAUNCHES["greedy_assign"]
    got = S.greedy_assign(*(a.cuda() for a in args), seed)
    torch.cuda.synchronize()
    assert LAUNCHES["greedy_assign"] == n0 + 1
    assert got.chosen.is_cuda
    for field in ("chosen", "assigned", "free_after"):
        assert bits_equal(getattr(plain, field).numpy(),
                          getattr(got, field).cpu().numpy()), field


@pytest.mark.card
@pytest.mark.parametrize("P,N,C", [(1024, 4096, 128), (384, 2000, 96)])
def test_shifted_seed_chunk_launches_match_plain_on_card(P, N, C):
    """The sharded greedy scan's launches (parallel/sharded_assign.py):
    one kernel launch per chunk of C rows under the seed shifted to the
    chunk's first row, ``free`` carried on the card, equals
    greedy_assign_plain on each chunk, and their concatenation equals
    one plain run over the whole batch."""
    from minisched_tpu_torch.ops.greedy_kernel import chunk_seed

    _need_card()
    rng = np.random.default_rng(P + N + C)
    scores, req, free0 = (torch.from_numpy(a) for a in greedy_case(
        rng, P, N, R=10, cpu_free=900.0))
    seed = prng.bits(prng.fold_in(prng.PRNGKey(19), P))
    whole = S.greedy_assign_plain(scores, req, free0, seed)
    free_dev, free_cpu = free0.cuda(), free0
    chosen = []
    n0 = LAUNCHES["greedy_assign"]
    for c in range(P // C):
        rows = slice(c * C, (c + 1) * C)
        s_c = chunk_seed(seed, c * C)
        got = greedy_assign_cuda(scores[rows].cuda(), req[rows].cuda(),
                                 free_dev, s_c)
        want = S.greedy_assign_plain(scores[rows], req[rows], free_cpu, s_c)
        for field in ("chosen", "assigned", "free_after"):
            assert bits_equal(getattr(want, field).numpy(),
                              getattr(got, field).cpu().numpy()), (c, field)
        free_dev, free_cpu = got.free_after, want.free_after
        chosen.append(got.chosen.cpu())
    assert LAUNCHES["greedy_assign"] == n0 + P // C
    assert torch.equal(torch.cat(chosen), whole.chosen)
    assert bits_equal(free_dev.cpu().numpy(), whole.free_after.numpy())


def _multiblock_case(kind, rng):
    """Cases that run up to 132 blocks of the kernel (one per SM of an
    H100), with uneven or empty column slices."""
    if kind == "wide":
        return greedy_case(rng, 512, 20000, R=10)
    if kind == "uneven":  # slices of 65 columns: the last two blocks are empty
        return greedy_case(rng, 256, 8449, R=10)
    if kind == "scarce":  # the owner's look-ahead often has to rescan
        return scarce_case(rng, 1024, 9000)
    if kind == "ties":  # scores 0 or 1: many equal scores across blocks
        return greedy_case(rng, 512, 16384, R=10, quant=1, infeasible=0.0)
    if kind == "all-neg-row":
        s, req, free = greedy_case(rng, 64, 5000, R=10)
        s[[0, 7, 63]] = NEG
        return s, req, free
    if kind == "negative-request":
        s, req, free = greedy_case(rng, 128, 5000, R=10, cpu_free=300.0)
        req[5, 2] = -3.0
        req[9, 0] = -250.0
        return s, req, free
    if kind == "empty-batch":
        s, req, free = greedy_case(rng, 1, 5000, R=10)
        return s[:0], req[:0], free
    if kind == "max-r":
        return greedy_case(rng, 96, 20000, R=32)
    if kind == "no-ring":  # the free slices leave no room for the score ring
        return greedy_case(rng, 64, 500000, R=10)
    raise ValueError(kind)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["wide", "uneven", "scarce", "ties",
                                  "all-neg-row", "negative-request",
                                  "empty-batch", "max-r", "no-ring"])
def test_kernel_matches_plain_on_card_multiblock(kind):
    _need_card()
    rng = np.random.default_rng(sum(map(ord, kind)))
    args = [torch.from_numpy(a) for a in _multiblock_case(kind, rng)]
    seed = prng.bits(prng.fold_in(prng.PRNGKey(5), len(kind)))
    plain = S.greedy_assign_plain(*args, seed)
    n0 = LAUNCHES["greedy_assign"]
    got = greedy_assign_cuda(*(a.cuda() for a in args), seed)
    torch.cuda.synchronize()
    # An empty batch only copies free0: no launch, so no count.
    assert LAUNCHES["greedy_assign"] == n0 + (kind != "empty-batch")
    for field in ("chosen", "assigned", "free_after"):
        assert bits_equal(getattr(plain, field).numpy(),
                          getattr(got, field).cpu().numpy()), field
    if kind not in ("empty-batch", "all-neg-row"):
        assert int(plain.assigned.sum()) > 0
    if kind == "all-neg-row":
        assert not plain.assigned[[0, 7, 63]].any()


@pytest.mark.card
def test_kernel_rejects_bad_inputs_on_card():
    _need_card()
    s, req, free = (torch.zeros(shape, device="cuda")
                    for shape in ((4, 8), (4, 3), (8, 3)))
    with pytest.raises(ValueError, match="float32"):
        greedy_assign_cuda(s, req, free.double(), 0)
    with pytest.raises(ValueError, match="shape"):
        greedy_assign_cuda(s, req[:3], free, 0)


def _scan_on_card(scores, req, free, seed, k):
    """The shortlist scan kernel and its plain version on one input."""
    args = [torch.from_numpy(a) for a in (scores, req, free)]
    k = min(max(k, 1), scores.shape[1])
    cand, kth, kthn = S.shortlist_select(args[0], seed, k)
    plain = S.greedy_assign_shortlist_plain(*args, seed, cand, kth, kthn)
    n0 = dict(LAUNCHES)
    dev = [a.cuda() for a in args]
    got = S.greedy_assign_shortlist(*dev, seed, k=k)
    torch.cuda.synchronize()
    # An empty batch only copies free0: no launch, so no count.
    for name in ("shortlist_select", "shortlist_scan"):
        assert LAUNCHES[name] == n0[name] + (scores.shape[0] > 0), name
    for field in ("chosen", "assigned", "free_after", "repaired"):
        assert bits_equal(getattr(plain, field).numpy(),
                          getattr(got, field).cpu().numpy()), field
    # The selection on the card equals the selection on the CPU.
    for a, b in zip(S.shortlist_select(dev[0], seed, k), (cand, kth, kthn)):
        assert bits_equal(a.cpu().numpy(), b.numpy())
    return plain


@pytest.mark.card
@pytest.mark.parametrize("name,P,N,R,seed,k,kw", SHORTLIST_CASES,
                         ids=[c[0] for c in SHORTLIST_CASES])
def test_shortlist_scan_matches_plain_on_card(name, P, N, R, seed, k, kw):
    _need_card()
    plain = _scan_on_card(*shortlist_case(P, N, R, seed, **kw),
                          prng.bits(prng.fold_in(prng.PRNGKey(seed), k)), k)
    if name == "contention":
        assert int(plain.repaired.sum()) > 0


@pytest.mark.card
@pytest.mark.parametrize("kind", ["contention-wide", "k1", "k-equals-n",
                                  "max-r", "max-r-k200", "odd-r",
                                  "k-above-ring", "scarce", "empty-batch",
                                  "device-layout", "no-bitmap"])
def test_shortlist_scan_edge_cases_on_card(kind):
    _need_card()
    rng = np.random.default_rng(sum(map(ord, kind)))
    seed = prng.bits(prng.fold_in(prng.PRNGKey(11), len(kind)))
    if kind == "contention-wide":  # repairs over a row wider than the block
        case, k = shortlist_case(256, 20000, 10, 5, contend=True), 16
    elif kind == "k1":  # every live pod repairs
        case, k = shortlist_case(64, 3000, 4, 6), 1
    elif kind == "k-equals-n":  # the shortlist is the row
        case, k = shortlist_case(64, 700, 4, 7), 700
    elif kind == "max-r":  # the R <= 32 build
        case, k = greedy_case(rng, 96, 5000, R=32), 128
    elif kind == "max-r-k200":  # R <= 32, candidates past the ring
        case, k = scarce_case(rng, 200, 3000, R=24), 200
    elif kind == "odd-r":  # 4-byte row copies
        case, k = scarce_case(rng, 300, 2000, R=5), 64
    elif kind == "k-above-ring":  # K > 128 at the R <= 16 build
        case, k = scarce_case(rng, 300, 4000), 300
    elif kind == "device-layout":  # the overlay does not fit: rows in
        case, k = shortlist_case(6000, 20000, 10, 4), 16  # free_after
    elif kind == "no-bitmap":  # nor N bits: every row from free_after
        case, k = shortlist_case(8, 2_000_000, 2, 3), 16
    elif kind == "scarce":
        case, k = scarce_case(rng, 512, 4000), 32
    else:
        s, req, free = greedy_case(rng, 1, 500, R=10)
        case, k = (s[:0], req[:0], free), 16
    plain = _scan_on_card(*case, seed, k)
    if kind in ("contention-wide", "k1"):
        assert int(plain.repaired.sum()) > 0


def _select_case(kind, rng):
    """Score rows for the selection kernel: (scores, K)."""
    if kind == "signed-zero":  # lax.top_k orders +0.0 above -0.0
        s = np.where(rng.random((12, 300)) < 0.5, 0.0, -0.0)
        for row in s:
            row[rng.choice(300, 3, replace=False)] = 5.0
        return s.astype(np.float32), 128
    if kind == "plateau":  # every node ties: only the noise orders them
        return np.full((16, 5000), 100.0, np.float32), 128
    if kind == "exact-tie":  # the K-th value shared far past K
        s = np.full((16, 3000), 40.0, np.float32)
        s[:, ::2] = 60.0
        return s, 128
    if kind == "all-neg":
        return np.full((8, 1000), NEG, np.float32), 16
    if kind == "k1":
        return greedy_case(rng, 64, 3000)[0], 1
    if kind == "k7":
        return greedy_case(rng, 64, 3000)[0], 7
    if kind == "k-equals-n":
        return greedy_case(rng, 16, 777)[0], 777
    if kind == "p-above-k":
        return greedy_case(rng, 300, 50, quant=1)[0], 8
    if kind == "row-not-cached":  # 60,000 columns do not fit in shared
        return rng.random((4, 60000), dtype=np.float32), 128  # memory
    if kind == "keys-not-in-shared":  # nor do 30,000 sort keys
        return rng.random((4, 60000), dtype=np.float32), 30000
    if kind == "wide-k-equals-n":
        return rng.random((2, 60000), dtype=np.float32), 60000
    if kind in SELECT_CARD_LIST_KINDS:
        return select_list_case(kind, rng)
    raise ValueError(kind)


SELECT_KINDS = (["signed-zero", "plateau", "exact-tie", "all-neg", "k1",
                 "k7", "k-equals-n", "p-above-k", "row-not-cached",
                 "keys-not-in-shared", "wide-k-equals-n"]
                + SELECT_CARD_LIST_KINDS)


def _select_on_card(scores, seed, k):
    want = S.shortlist_select_plain(torch.from_numpy(scores), seed, k)
    n0 = LAUNCHES["shortlist_select"]
    got = shortlist_select_cuda(torch.from_numpy(scores).cuda(), seed, k)
    torch.cuda.synchronize()
    assert LAUNCHES["shortlist_select"] == n0 + (scores.shape[0] > 0)
    for a, b, name in zip(got, want, ("cand", "kth", "kth_noise")):
        assert bits_equal(b.numpy(), a.cpu().numpy()), name
    gathered = np.take_along_axis(scores, want[0].numpy().astype(np.int64),
                                  axis=1)
    assert bits_equal(gathered, got[3].cpu().numpy()), "cand_scores"


@pytest.mark.card
@pytest.mark.parametrize("kind", SELECT_KINDS)
def test_shortlist_select_matches_plain_on_card(kind):
    _need_card()
    rng = np.random.default_rng(sum(map(ord, kind)))
    scores, k = _select_case(kind, rng)
    _select_on_card(scores, prng.bits(prng.fold_in(prng.PRNGKey(13), k)), k)


@pytest.mark.card
@pytest.mark.parametrize("name,P,N,R,seed,k,kw", SHORTLIST_CASES,
                         ids=[c[0] for c in SHORTLIST_CASES])
def test_shortlist_select_on_shortlist_cases_on_card(name, P, N, R, seed, k,
                                                     kw):
    _need_card()
    scores = shortlist_case(P, N, R, seed, **kw)[0]
    _select_on_card(scores, prng.bits(prng.fold_in(prng.PRNGKey(seed), k)),
                    min(k, N))


@pytest.mark.card
def test_shortlist_select_empty_batch_and_bad_inputs_on_card():
    _need_card()
    _select_on_card(np.zeros((0, 50), np.float32), 3, 4)
    s = torch.zeros((4, 8), device="cuda")
    with pytest.raises(ValueError, match="float32"):
        shortlist_select_cuda(s.double(), 0, 2)
    with pytest.raises(ValueError, match="k"):
        shortlist_select_cuda(s, 0, 9)
    with pytest.raises(ValueError, match="2-D"):
        shortlist_select_cuda(s[0], 0, 2)


@pytest.mark.card
def test_shortlist_scan_rejects_bad_inputs_on_card():
    _need_card()
    s = torch.zeros((4, 8), device="cuda")
    cand = torch.zeros((4, 2), dtype=torch.int32, device="cuda")
    kth = torch.zeros(4, device="cuda")
    req, free = torch.zeros((4, 3), device="cuda"), torch.zeros((8, 3),
                                                                device="cuda")
    with pytest.raises(ValueError, match="int32"):
        shortlist_scan_cuda(s, cand.long(), kth, kth, req, free, 0)
    with pytest.raises(ValueError, match="shape"):
        shortlist_scan_cuda(s, cand, kth[:3], kth, req, free, 0)
    with pytest.raises(ValueError, match="R <= 32"):
        shortlist_scan_cuda(s, cand, kth, kth, torch.zeros((4, 33),
                                                           device="cuda"),
                            torch.zeros((8, 33), device="cuda"), 0)


@pytest.mark.card
@pytest.mark.parametrize("seed,P", [(0, 200), (1, 200), (2, 0)],
                         ids=["0", "1", "empty"])
def test_insert_ports_matches_plain_on_card(seed, P):
    _need_card()
    state, rows, ports = ports_case(np.random.default_rng(seed), N=300,
                                    PORT=40, P=max(P, 1), PP=6)
    rows, ports = rows[:P], ports[:P]
    want = RES.insert_ports_plain(*(torch.from_numpy(a)
                                    for a in (state, rows, ports)))
    n0 = LAUNCHES["insert_ports"]
    got = RES.insert_ports(torch.from_numpy(state).cuda(), rows, ports)
    torch.cuda.synchronize()
    # With no pods the launcher only copies the state: no count.
    assert LAUNCHES["insert_ports"] == n0 + (P > 0)
    assert bits_equal(want.numpy(), got.cpu().numpy())
    mirror = state.copy()
    RES.replay_ports_host(mirror, rows, ports)
    assert bits_equal(mirror, got.cpu().numpy())


@pytest.mark.card
@pytest.mark.parametrize("kind", PORTS_DESIGN_KINDS + ["all-on-one-row-1024",
                                                       "bucket-of-1"])
def test_insert_ports_design_cases_on_card(kind):
    """The grouped insertion's hard cases: 1024 pods on one row (the
    longest chain), every pod on its own row, full rows, -1 padding,
    duplicate ports, PORT = 3 and 40, a bucket of one pod."""
    _need_card()
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "all-on-one-row-1024":
        state, rows, ports = ports_design_case("one-row", rng, P=1024)
    elif kind == "bucket-of-1":
        state, rows, ports = ports_design_case("distinct-rows", rng, P=1)
        ports[0, 0] = 8080
    else:
        state, rows, ports = ports_design_case(kind, rng)
    want = RES.insert_ports_plain(*(torch.from_numpy(a)
                                    for a in (state, rows, ports)))
    n0 = LAUNCHES["insert_ports"]
    got = RES.insert_ports(torch.from_numpy(state).cuda(), rows, ports)
    torch.cuda.synchronize()
    assert LAUNCHES["insert_ports"] == n0 + 1
    assert bits_equal(want.numpy(), got.cpu().numpy())
    assert not bits_equal(state, got.cpu().numpy())


def _sampled_case(kind, rng, P=1024, N=4096, R=10):
    """A batch at the sampled shape of bench-50k (1024 pods x the 4,096
    sampled nodes): bench-like scores (a quarter of each row at each of
    four values, 1% NEG), integer-valued requests and free capacity;
    ``contention`` starves all but a few nodes so the scan repairs."""
    s = rng.choice(np.float32([181.25, 190.625, 195.3125, 196.875]), (P, N))
    s[rng.random((P, N)) < 0.01] = NEG
    req = rng.integers(1, 8, (P, R)).astype(np.float32) * 250
    free = rng.integers(8, 129, (N, R)).astype(np.float32) * 250
    if kind == "contention":
        free[:] = 250.0
        free[: N // 64] = 1e7
    return s.astype(np.float32), req, free


@pytest.mark.card
@pytest.mark.parametrize("kind", ["bench-like", "contention"])
def test_selection_and_scan_at_the_sampled_shape_on_card(kind):
    """The selection and scan kernels at 1024 x 4096 (the default
    config's node sample at bench-50k) equal their plain versions, and
    the scan equals the greedy kernel there."""
    _need_card()
    scores, req, free = _sampled_case(kind, np.random.default_rng(4096))
    seed = prng.bits(prng.split(prng.fold_in(prng.PRNGKey(0), 1))[0])
    _select_on_card(scores, seed, 128)
    plain = _scan_on_card(scores, req, free, seed, 128)
    full = greedy_assign_cuda(*(torch.from_numpy(a).cuda()
                                for a in (scores, req, free)), seed)
    for field in ("chosen", "assigned", "free_after"):
        assert bits_equal(getattr(plain, field).numpy(),
                          getattr(full, field).cpu().numpy()), field
    if kind == "contention":
        assert int(plain.repaired.sum()) > 0


@pytest.mark.card
@pytest.mark.parametrize("shortlist", [128, None])
def test_sampled_step_on_card_equals_cpu(shortlist):
    """A sampled build_step (3,000 bench nodes, 1,024 pods, K=1,024) on
    the card: every Decision field equal to the CPU's."""
    _need_card()
    from minisched_tpu_torch.encode import (NodeFeatureCache, encode_pods,
                                            to_torch)
    from minisched_tpu_torch.ops.pipeline import build_step
    from minisched_tpu_torch.service.defaultconfig import Profile
    from minisched_tpu_torch.state import objects as TO
    from torch_parity import BENCH_PROFILE, bench_cluster

    nodes, pods = bench_cluster(TO, 3000, 1024, 5)
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes)
    nf, _names, _sv, _incs = cache.snapshot_versioned(pad=3072)
    eb = encode_pods(pods, 1024, cfg=cache.cfg, registry=cache.registry)
    af = cache.snapshot_assigned(pad=16)
    step = build_step(Profile(**BENCH_PROFILE).build(), shortlist=shortlist,
                      sample_nodes=1024)
    key = prng.fold_in(prng.PRNGKey(5), 1)
    got = step(*(to_torch(x, "cuda") for x in (eb, nf, af)), key)
    want = step(*(to_torch(x, "cpu") for x in (eb, nf, af)), key)
    for field in want._fields:
        assert bits_equal(getattr(want, field).numpy(),
                          getattr(got, field).cpu().numpy()), field
    assert int(want.assigned.sum()) == 1024


def test_caps_wrapper_refuses_cpu_tensors():
    scores, req, free, seed, caps = caps_problem("spreadcap-burst")
    with pytest.raises(ValueError, match="CUDA"):
        caps_scan_cuda(scores, req, free, seed, caps)


@pytest.mark.parametrize("kind", ["spreadcap-burst", "all-unenforced"])
def test_caps_dispatch_on_cpu_is_the_plain_version(kind):
    scores, req, free, seed, caps = caps_problem(kind)
    n0 = dict(LAUNCHES)
    got = S.greedy_assign(scores, req, free, seed, caps=caps)
    want = S.greedy_assign_plain(scores, req, free, seed, caps)
    assert LAUNCHES == n0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("kind", CAPS_KINDS)
def test_caps_kernel_matches_plain_on_card(kind):
    """The caps scan kernel equals its plain version bitwise on chosen,
    assigned and free_after: tests/test_spreadcap.py's shapes, random
    hard batches, groups that do not compact, no slot enforced, and a
    3,000-node batch over many blocks."""
    _need_card()
    scores, req, free, seed, caps = caps_problem(kind)
    want = S.greedy_assign_plain(scores, req, free, seed, caps)
    n0 = LAUNCHES["caps_scan"]
    got = S.greedy_assign(scores.cuda(), req.cuda(), free.cuda(), seed,
                          caps=type(caps)(*[t.cuda() for t in caps]))
    torch.cuda.synchronize()
    assert LAUNCHES["caps_scan"] == n0 + 1
    for field in ("chosen", "assigned", "free_after"):
        assert bits_equal(getattr(want, field).numpy(),
                          getattr(got, field).cpu().numpy()), field


@pytest.mark.card
@pytest.mark.parametrize("profile", ["bench", "c4-soft"])
@pytest.mark.parametrize("sample", [None, 1024])
def test_step_makes_no_host_sync_on_card(profile, sample):
    """A gang-free step with no DoNotSchedule slot (the bench profile, and
    config 4 soft), sampled and unsampled, runs under torch's sync debug
    mode "error": the host never waits for the card."""
    _need_card()
    import chip_smoke
    from minisched_tpu_torch.encode import (NodeFeatureCache, encode_pods,
                                            to_torch)
    from minisched_tpu_torch.ops.pipeline import build_step

    if profile == "bench":
        nodes, pods = chip_smoke.bench_workload(3000, 1024)
        prof = chip_smoke.BENCH_PROFILE
    else:
        nodes, pods = chip_smoke.c4_workload(3000, 1024)
        prof = chip_smoke.C4_PROFILE
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes)
    eb = encode_pods(pods, 1024, cfg=cache.cfg, registry=cache.registry)
    nf, _names, _sv, _incs = cache.snapshot_versioned(pad=3072)
    af = cache.snapshot_assigned(pad=16)
    step = build_step(prof.build(), shortlist=128, sample_nodes=sample)
    key = prng.fold_in(prng.PRNGKey(5), 1)
    args = [to_torch(x, "cuda") for x in (eb, nf, af)]
    step(*args, key, has_gang=False, hard_spread=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d = step(*args, key, has_gang=False, hard_spread=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(d.assigned.sum()) == 1024


@pytest.mark.card
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preempt_op_on_card_equals_cpu(seed):
    """The preemption candidate op (full_scheduler_profile()'s filters,
    every topology cure on) on a topology-heavy corpus: its four outputs
    on the card equal the CPU's bitwise (the card's segment sums add by
    atomics), and it never waits on the host."""
    _need_card()
    from minisched_tpu_torch.encode import (NodeFeatureCache, encode_pods,
                                            to_torch)
    from minisched_tpu_torch.ops.preempt import build_preempt_op
    from minisched_tpu_torch.service.defaultconfig import (
        full_scheduler_profile)
    from minisched_tpu_torch.state import objects as TO
    from torch_parity import full_cluster

    nodes, pending, bound = full_cluster(TO, 400, 64, seed)
    rng = np.random.default_rng(seed + 100)
    for p in pending:
        p.spec.priority = int(rng.integers(1, 6))
        p.spec.requests["cpu"] = float(rng.integers(4, 16) * 100)
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes)
    for p, node_name in bound:
        p.spec.node_name = node_name
        cache.account_bind(p)
    eb = encode_pods(pending, 64, cfg=cache.cfg, registry=cache.registry,
                     anti_forbidden_fn=cache.anti_forbidden_for)
    nf, _names, _sv, _incs = cache.snapshot_versioned()
    af = cache.snapshot_assigned()
    op = build_preempt_op(full_scheduler_profile().build(), cfg=cache.cfg)
    want = op(*(to_torch(x, "cpu") for x in (eb, nf, af)))
    args = [to_torch(x, "cuda") for x in (eb, nf, af)]
    op(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = op(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(got, want):
        assert bits_equal(a.cpu().numpy(), b.numpy())
    assert bool(want[1].any())


# ---- the auction kernels --------------------------------------------------


def _port_noise(seed):
    """The port's tie noise lattice of ``seed`` as f(i, cols) -> numpy."""
    def noise(i, cols):
        return S.tie_noise_from_cols(
            seed, torch.as_tensor(np.asarray(i, np.int64)),
            torch.as_tensor(np.asarray(cols, np.int64))).numpy()
    return noise


def test_auction_wrappers_refuse_cpu_tensors():
    args = (torch.zeros((2, 3)), torch.zeros((2, 4)), torch.zeros((3, 4)), 0)
    with pytest.raises(ValueError, match="CUDA"):
        auction_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        bid_auction_cuda(*args, k=2)


def test_auction_dispatch_on_cpu_is_the_plain_version():
    scores, req, free = (torch.from_numpy(a)
                         for a in auction_adversarial(2))
    n0 = dict(LAUNCHES)
    got = auction_assign_shortlist(scores, req, free, 99, k=2)
    want = auction_assign_shortlist_plain(scores, req, free, 99, k=2)
    assert LAUNCHES == n0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _auction_on_card(scores, req, free, seed, prio=None, k=None,
                     max_rounds=None):
    """One kernel against its plain version: every output, the rounds run
    and one counted launch (none for an empty batch). Returns the plain
    result."""
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (scores, req, free)]
    tp = None if prio is None else torch.from_numpy(np.asarray(prio,
                                                               np.int32))
    r_plain = torch.zeros((3,), dtype=torch.int32)
    r_card = torch.full((1,), -1, dtype=torch.int32, device="cuda")
    dev = [a.cuda() for a in args]
    dp = None if tp is None else tp.cuda()
    name = "auction" if k is None else "bid_auction"
    n0 = LAUNCHES[name]
    if k is None:
        plain = auction_assign_plain(*args, seed, max_rounds=max_rounds,
                                     priority=tp, stats=r_plain)
        got = auction_cuda(*dev, seed, max_rounds=max_rounds, priority=dp,
                           rounds=r_card)
        fields = ("chosen", "assigned", "free_after")
    else:
        plain = auction_assign_shortlist_plain(
            *args, seed, max_rounds=max_rounds, priority=tp, k=k,
            stats=r_plain)
        got = bid_auction_cuda(*dev, seed, max_rounds=max_rounds,
                               priority=dp, k=k, rounds=r_card)
        fields = ("chosen", "assigned", "free_after", "repaired")
    torch.cuda.synchronize()
    assert LAUNCHES[name] == n0 + (scores.shape[0] > 0)
    for field in fields:
        assert bits_equal(getattr(plain, field).numpy(),
                          getattr(got, field).cpu().numpy()), field
    assert int(r_card[0]) == int(r_plain[0])
    return plain


@pytest.mark.card
@pytest.mark.parametrize("case,k", [(c, k) for c in sorted(AUCTION_CASES)
                                    for k in (None,) + AUCTION_CASES[c][2]])
def test_auction_kernels_match_plain_on_card(case, k):
    _need_card()
    make, prio, _widths = AUCTION_CASES[case]
    seed = prng.bits(prng.fold_in(prng.PRNGKey(7), len(case)))
    plain = _auction_on_card(*make(), seed, prio=prio, k=k)
    assert int(plain.assigned.sum()) > 0


@pytest.mark.card
@pytest.mark.parametrize("k", [None, 1, 2])
@pytest.mark.parametrize("kind", ["fold", "strength", "tie"])
def test_auction_kernels_round_once_on_card(kind, k):
    """The fold and the strength are one fused multiply-add on the card
    too, and equal strengths go to the higher row."""
    _need_card()
    seed = prng.bits(prng.PRNGKey(5))
    noise = _port_noise(seed)
    if kind == "fold":
        scores, _win = auction_fold_case(noise)
        req, free = np.ones((1, 1), np.float32), np.ones((2, 1), np.float32)
    elif kind == "strength":
        scores, _win, _split = auction_strength_case(noise)
        req = np.ones((scores.shape[0], 1), np.float32)
        free = np.array([[1.0], [0.0]], np.float32)
    else:
        scores, req, free = auction_tie_case(noise)
        k = None if k is None else min(k + 1, 3)
    _auction_on_card(scores, req, free, seed, k=k)


@pytest.mark.card
@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("budget", [1, 2, 4])
def test_auction_round_budget_on_card(k, budget):
    _need_card()
    plain = _auction_on_card(*auction_adversarial(1), 1234, k=k,
                             max_rounds=budget)
    assert int((~plain.assigned).sum()) > 0


@pytest.mark.card
@pytest.mark.parametrize("k", [None, 4])
def test_auction_empty_batch_on_card(k):
    _need_card()
    scores, req, free = auction_adversarial(0)
    _auction_on_card(scores[:0], req[:0], free, 1, k=k)


@pytest.mark.card
@pytest.mark.parametrize("k", [None, 2, 128])
def test_auction_kernels_uncached_rows_on_card(k):
    """Rows of 65,536 columns, whose 4N key bytes do not fit in a block's
    shared memory: the bid shortlist's selection folds every score again
    in each pass. Every pod wants nodes 0-3, which fit one pod each, so
    at K=2 the rest find their candidates closed and are repaired; row 5
    has 50 feasible columns, fewer than K=128, so its selection takes the
    column-ordered ties at NEG."""
    _need_card()
    rng = np.random.default_rng(16)
    P, N = 16, 65536
    scores = rng.integers(0, 4, (P, N)).astype(np.float32)
    scores[:, :4] = 10.0
    scores[5, 50:] = NEG
    req = np.ones((P, 2), np.float32)
    free = np.full((N, 2), 4.0, np.float32)
    free[:4] = 1.0
    plain = _auction_on_card(scores, req, free, 4321, k=k)
    assert int(plain.assigned.sum()) == P
    if k == 2:
        assert int(plain.repaired.sum()) >= P - 4


@pytest.mark.card
@pytest.mark.parametrize("case", AUCTION_SELECT_CASES)
def test_bid_auction_selection_paths_on_card(case):
    """The bid-shortlist kernel's threshold selection on each of its
    paths (tests/torch_parity.auction_select_case: ties at kth past the
    list's capacity walked across 512-column strides, whole-row
    plateaus, zeros at kth, K = N, and rows of 65,536 columns taking the
    ranked, exact, walked and infeasible paths in one launch) against
    the plain version: every output and the rounds run."""
    _need_card()
    scores, req, free, k = auction_select_case(case)
    plain = _auction_on_card(scores, req, free, 4321, k=k)
    assert int(plain.assigned.sum()) > 0


@pytest.mark.card
@pytest.mark.parametrize("shortlist", [16, None])
def test_auction_step_past_the_old_cap_on_card(shortlist):
    """16,385 pods through build_step(assignment="auction") (the step pads
    them to 18,432 rows, so the kernel sees P = 18,432) on the card, with
    and without the bid shortlist: every Decision field equal to the
    CPU's. Only the last 65 pods fit a node: the rows past the kernels'
    old cap of 16,384 do the work."""
    _need_card()
    from minisched_tpu_torch.encode import (NodeFeatureCache, encode_pods,
                                            to_torch)
    from minisched_tpu_torch.encode.cache import step_bucket
    from minisched_tpu_torch.ops.pipeline import build_step
    from minisched_tpu_torch.service.defaultconfig import Profile
    from minisched_tpu_torch.state import objects as TO
    from torch_parity import (BENCH_PROFILE, OLD_AUCTION_CAP,
                              auction_past_cap_cluster)

    nodes, pods = auction_past_cap_cluster(TO)
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes)
    nf, _names, _sv, _incs = cache.snapshot_versioned(pad=64)
    eb = encode_pods(pods, step_bucket(len(pods)), cfg=cache.cfg,
                     registry=cache.registry)
    af = cache.snapshot_assigned(pad=16)
    assert eb.pf.requests.shape[0] == 18432 > OLD_AUCTION_CAP + 1
    step = build_step(Profile(**BENCH_PROFILE).build(), shortlist=shortlist,
                      assignment="auction")
    key = prng.fold_in(prng.PRNGKey(11), 1)
    name = "auction" if shortlist is None else "bid_auction"
    n0 = LAUNCHES[name]
    got = step(*(to_torch(x, "cuda") for x in (eb, nf, af)), key)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == n0 + 1
    want = step(*(to_torch(x, "cpu") for x in (eb, nf, af)), key)
    for field in want._fields:
        assert bits_equal(getattr(want, field).numpy(),
                          getattr(got, field).cpu().numpy()), field
    placed = want.assigned.numpy().nonzero()[0]
    assert len(placed) > 0 and placed.min() >= len(pods) - 65
    assert bool(want.assigned[len(pods) - 1])


@pytest.mark.card
@pytest.mark.parametrize("k", [None, 1, 2])
def test_auction_kernels_past_the_shared_memory_wall_on_card(k):
    """1,300,000 pods against 2 nodes: a block's share of the batch (about
    9,850 pods of 24 bytes) no longer fits in its shared memory, where the
    kernels kept every pod before. The feasible rows are the last 48, in
    three bands contending for 2 nodes; every other row is NEG. Both
    kernels against their plain versions: every output, the rounds run."""
    _need_card()
    from torch_parity import auction_past_cap

    P = 1_300_000
    scores, req, free, prio = auction_past_cap(P=P, N=2, n_feasible=48,
                                               seed=44)
    plain = _auction_on_card(scores, req, free, 2468, prio=prio, k=k)
    placed = plain.assigned.numpy().nonzero()[0]
    assert len(placed) > 0 and placed.min() >= P - 48
    from minisched_tpu_torch.ops.auction_kernel import bid_auction_layout

    assert not bid_auction_layout(P, 2)["shared_pods"]


@pytest.mark.card
def test_bid_auction_layout_on_card():
    """The bid-shortlist kernel keeps each row's keys in shared memory at
    the bench shapes (1,024 x 4,096 sampled, 1,024 x 53,248 unsampled) and
    at 18,432 x 53,248 (the step past the old cap), with every block's
    pods beside them; a row too wide for the cache turns it off, and a
    batch too large for the pods sends them to device memory."""
    _need_card()
    from minisched_tpu_torch.ops.auction_kernel import bid_auction_layout

    for P, N in ((1024, 4096), (1024, 53248), (18432, 53248)):
        lay = bid_auction_layout(P, N)
        assert lay["cache_keys"] and lay["shared_pods"], (P, N, lay)
    assert not bid_auction_layout(1024, 65536)["cache_keys"]
    lay = bid_auction_layout(1_300_000, 53248)
    assert lay["cache_keys"] and not lay["shared_pods"], lay


# ---- the tenant-lane form of the selection and scan kernels -------------


def _lane_case(T, P, N, R, contend_every=2):
    """T lanes of one shape: every second lane starved (its scan
    repairs), the others roomy; lane t's live rows end at P - 29t (the
    padding rows NEG everywhere, as the engine's masked totals are)."""
    parts = [shortlist_case(P, N, R, 100 + t, contend=(t % contend_every
                                                      == 1))
             for t in range(T)]
    scores, req, free = (np.stack(x) for x in zip(*parts))
    for t in range(T):
        scores[t, max(P - 29 * t, 0):] = NEG
    return scores, req, free


@pytest.mark.card
@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("k", [16, 128, 256])
def test_lane_kernels_match_plain_and_solo_on_card(T, k):
    """One selection launch and one scan launch serve T lanes: every
    output equals the lane-looped plain versions bitwise and each lane
    equals its own solo launch; K = 256 runs past the scan's ring
    (kRingK); the starved lanes repair."""
    _need_card()
    P, N, R = 256, 3000, 4
    scores, req, free = _lane_case(T, P, N, R)
    seeds = [prng.bits(prng.fold_in(prng.PRNGKey(9), t)) for t in range(T)]
    cpu = [torch.from_numpy(a) for a in (scores, req, free)]
    cand, kth, kthn = S.shortlist_select_lanes_plain(cpu[0], seeds, k)
    plain = S.greedy_assign_shortlist_lanes_plain(*cpu, seeds, cand, kth,
                                                  kthn)
    dev = [a.cuda() for a in cpu]
    n0 = dict(LAUNCHES)
    got = S.greedy_assign_shortlist_lanes(*dev, seeds, k=k)
    torch.cuda.synchronize()
    for name in ("shortlist_select", "shortlist_scan"):
        assert LAUNCHES[name] == n0[name] + 1, name
    for field in ("chosen", "assigned", "free_after", "repaired"):
        assert bits_equal(getattr(plain, field).numpy(),
                          getattr(got, field).cpu().numpy()), field
    sel = shortlist_select_lanes_cuda(dev[0], S.lane_seeds(seeds, "cuda"), k)
    for a, b in zip(sel, (cand, kth, kthn)):
        assert bits_equal(a.cpu().numpy(), b.numpy())
    for t in range(T):
        solo = S.greedy_assign_shortlist(dev[0][t], dev[1][t], dev[2][t],
                                         seeds[t], k=k)
        for field in ("chosen", "assigned", "free_after", "repaired"):
            assert bits_equal(getattr(solo, field).cpu().numpy(),
                              getattr(got, field)[t].cpu().numpy()), (t,
                                                                      field)
    if T > 1:
        assert bool(plain.repaired[1].any())


@pytest.mark.card
def test_lane_wrappers_reject_bad_inputs_on_card():
    _need_card()
    s = torch.zeros((2, 3, 5), device="cuda")
    seeds = torch.zeros((2,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="seeds"):
        shortlist_select_lanes_cuda(s, seeds[:1], 2)
    with pytest.raises(ValueError, match="seeds"):
        shortlist_select_lanes_cuda(s, seeds.long(), 2)
    cand, kth, kthn, cs = shortlist_select_lanes_cuda(s, seeds, 2)
    req = torch.zeros((2, 3, 2), device="cuda")
    free = torch.zeros((2, 5, 2), device="cuda")
    with pytest.raises(ValueError, match="free0"):
        shortlist_scan_lanes_cuda(s, cand, kth, kthn, req, free[:1], seeds)
    with pytest.raises(ValueError, match="seeds"):
        shortlist_scan_lanes_cuda(s, cand, kth, kthn, req, free, seeds[:1])
