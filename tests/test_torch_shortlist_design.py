"""Numpy models of the shortlist and port kernels' algorithms, held
bitwise against the JAX package's shortlist_select,
greedy_assign_shortlist and port insertion.

csrc/shortlist_select.cu selects each row's shortlist without the (P,N)
noise lattice. Its list path: every thread's largest order key (pass 1,
while the row lands in shared memory), L = the K-th largest of those
maxima, a list of every node above L and of the nodes at L whose noise
clears a floor T (pass 2), and the list sorted by the composite key; a
list that overflowed or came up short is rebuilt once with a floor from
exact counts, else the row takes the exact path. The exact path (and
every row with K > 384): radix selects over the order key of the scores
(kth) and over the boundary's 24-bit noise (the threshold t), a column
select where t is shared by more nodes than slots are left, then a
bitonic network over the K picks' 64-bit keys. csrc/shortlist_scan.cu
walks the pods against a ring of candidate rows copied from the constant
free0 and a shared-memory overlay of the batch's debited rows (an
open-addressing table from column to slot), repairs over free0 (+)
overlay, and writes the overlay back at the end. csrc/insert_ports.cu
places each pod's ports by their rank among the node's ports: the k-th
nonzero port of a node (pod order, then slot order) fills the k-th zero
slot of the row as it entered the batch. Each kernel is exact only if
its algorithm is; this file checks the algorithms on the CPU, step for
step as the kernels take them (tolerance 0: one ulp moves a tie-break).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from minisched_tpu.ops import residency as JR
from minisched_tpu.ops.select import greedy_assign_shortlist as jshortlist
from minisched_tpu.ops.select import seed_from_key
from minisched_tpu.ops.select import shortlist_select as jselect
from minisched_tpu_torch.ops import prng
from torch_parity import (NEG, PORTS_DESIGN_KINDS, SELECT_LIST_KINDS,
                          SHORTLIST_CASES, bits_equal, ports_case,
                          ports_design_case, scarce_case, select_list_case,
                          shortlist_case)

M32 = 0xFFFFFFFF
NEG32 = np.float32(NEG)


def noise24(seed, i, cols):
    """fmix32(col * 0x85EBCA77 + seed + i * 0x9E3779B9) >> 8 in u32."""
    x = (np.asarray(cols, np.uint64) * 0x85EBCA77 + seed
         + (i * 0x9E3779B9)) & M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    x ^= x >> 16
    return (x >> 8).astype(np.int64)


def order_key(s):
    """The u32 key of lax.top_k's total order (-0.0 below +0.0)."""
    u = np.asarray(s, np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u >> 31, u ^ M32, u ^ 0x80000000)


def order_key_inv(k):
    k = int(k)
    u = k ^ (0x80000000 if k >> 31 else M32)
    return np.array(u, np.uint32).view(np.float32)[()]


def select_bin(hist, krem, desc):
    """The kernel's warp select: the bin holding the krem-th node counted
    from the top (desc) or bottom bin; (bin, krem within it, its count)."""
    order = range(255, -1, -1) if desc else range(256)
    acc = 0
    for b in order:
        if acc < krem <= acc + hist[b]:
            return b, krem - acc, int(hist[b])
        acc += int(hist[b])
    raise AssertionError("krem beyond the histogram")


def radix_pass(values, live, prefix, pmask, shift, krem, desc):
    """One digit pass: the histogram of the live nodes matching the
    prefix, then the select."""
    take = live & ((values & pmask) == prefix)
    hist = np.bincount(((values[take] >> shift) & 255).astype(np.int64),
                       minlength=256)
    b, krem, count = select_bin(hist, krem, desc)
    return prefix | (b << shift), pmask | (255 << shift), krem, count


def bitonic_desc(keys):
    """The kernel's network: every block sorted descending, each merge
    opening with the mirror compare; partners past len(keys) skipped."""
    keys = list(keys)
    n = len(keys)
    npow = 1
    while npow < n:
        npow <<= 1
    size = 2
    while size <= npow:
        stride = size >> 1
        while stride > 0:
            for a in range(npow):
                b = a ^ (size - 1) if stride == size >> 1 else a ^ stride
                if a < b < n and keys[b] > keys[a]:
                    keys[a], keys[b] = keys[b], keys[a]
            stride >>= 1
        size <<= 1
    return keys


def exact_row(s, seed, i, k, stats=None):
    """The kernel's exact path on one row: (cand, kth, kth_noise)."""
    N = s.shape[0]
    cols = np.arange(N)
    every = np.ones(N, bool)
    keys = order_key(s)
    prefix = pmask = 0
    krem = k
    for shift in (24, 16, 8, 0):
        prefix, pmask, krem, _ = radix_pass(keys, every, prefix, pmask,
                                            shift, krem, True)
    kv = order_key_inv(prefix)
    above = s > kv
    bnd = s == kv
    need = k - int(above.sum())
    assert need >= 1
    nz = noise24(seed, i, cols)
    t = tmask = 0
    krem = need
    for shift in (16, 8, 0):
        t, tmask, krem, tcount = radix_pass(nz, bnd, t, tmask, shift,
                                            krem, True)
    ct = M32
    if tcount > krem:  # the lowest columns among noise == t
        if stats is not None:
            stats["column passes"] += 1
        top = 0
        while top < 24 and (N - 1) >> (top + 8):
            top += 8
        ct = cmask = 0
        tie = bnd & (nz == t)
        for shift in range(top, -1, -8):
            ct, cmask, krem, _ = radix_pass(cols, tie, ct, cmask, shift,
                                            krem, False)
    pick_b = bnd & ((nz > t) | ((nz == t) & (cols <= ct)))
    picks = ([((1 << 24) << 32) | (~j & M32) for j in cols[above]]
             + [(int(nz[j]) << 32) | (~j & M32) for j in cols[pick_b]])
    assert len(picks) == k
    return ([~int(x) & M32 for x in bitonic_desc(picks)], kv,
            np.float32(t) * np.float32(1.0 / (1 << 24)))


THREADS, CAP, FAST_K = 1024, 1024, 384
ZERO_KEYS = (0x80000000, 0x7FFFFFFF)  # the order keys of +0.0 and -0.0


def noise_floor(need, b):
    """The floor T at which about 1.5 * need + 32 of b uniform 24-bit
    noises are >= T."""
    want = need + need // 2 + 32
    return 0 if want >= b else (1 << 24) - (want << 24) // b


def list_row(s, seed, i, k, stats):
    """The kernel's list path on one row; None where it hands the row to
    the exact path."""
    N = s.shape[0]
    keys = order_key(s).astype(np.int64)
    tid = np.arange(N) % THREADS  # chunks of whole strides
    mx = np.zeros(THREADS, np.int64)  # threads without nodes hold 0
    np.maximum.at(mx, tid, keys)
    cm = np.bincount(tid[keys == mx[tid]], minlength=THREADS)
    L = int(np.sort(mx)[::-1][k - 1])  # the K-th largest thread maximum
    over = int((mx > L).sum())
    at_l = int(cm[mx == L].sum())
    if L in ZERO_KEYS:
        stats["signed-zero L"] += 1
        return None
    cols = np.arange(N)
    nz_all = None

    def compact(T):
        nonlocal nz_all
        up = keys > L
        eq = keys == L
        if nz_all is None:
            nz_all = noise24(seed, i, cols)
        take = eq & (nz_all >= T)
        return up.sum(), eq.sum(), take.sum(), cols[up | take]

    def fits(a, et):
        return a + et <= CAP and (a >= k or a + et >= k)

    a, e, et, lst = compact(noise_floor(k - over, at_l))
    if not fits(a, et):
        stats["rebuilt"] += 1
        a, e, et, lst = compact(1 << 24 if a >= k else
                                noise_floor(k - int(a), int(e)))
        if not fits(a, et):
            return None
    kkey = L
    if a >= k:  # kth lies above L: the K-th key of the list
        stats["kth above L"] += 1
        by_key = [(int(keys[j]) << 32) | (~int(j) & M32) for j in lst]
        kkey = int(sorted(by_key, reverse=True)[k - 1] >> 32)
    else:
        stats["kth = L"] += 1
    kv = order_key_inv(kkey)
    comp = []
    for j in lst:  # float compares, as JAX's composite key
        cls = 0
        if s[j] > kv:
            cls = (1 << 24) + 1
        elif s[j] == kv:
            cls = int(noise24(seed, i, j)) + 1
        comp.append((cls << 32) | (~int(j) & M32))
    top = sorted(comp, reverse=True)[:k]  # the kernel's bitonic network
    stats["list size"] = max(stats["list size"], len(lst))
    return ([~int(x) & M32 for x in top], kv,
            np.float32((top[-1] >> 32) - 1) * np.float32(1.0 / (1 << 24)))


def select_model(scores, seed, k, stats=None):
    """csrc/shortlist_select.cu, row by row. Returns (cand, kth,
    kth_noise) as the kernel writes them; ``stats`` counts the branches
    taken."""
    if stats is None:
        stats = {}
    for name in ("column passes", "signed-zero L", "rebuilt", "exact",
                 "kth above L", "kth = L", "list size"):
        stats.setdefault(name, 0)
    P, N = scores.shape
    cand = np.zeros((P, k), np.int32)
    kth = np.zeros(P, np.float32)
    kthn = np.zeros(P, np.float32)
    for i in range(P):
        row = list_row(scores[i], seed, i, k, stats) if k <= FAST_K else None
        if row is None:
            stats["exact"] += 1
            row = exact_row(scores[i], seed, i, k, stats)
        cand[i], kth[i], kthn[i] = row
    return cand, kth, kthn


class Overlay:
    """The scan kernel's debited rows. A bitmap marks the debited columns.
    "shared": a table of 2^bits {column, slot} entries (at least four per
    slot) with linear probing, the slots' rows and their columns;
    "device": the rows are free_after's."""

    def __init__(self, layout, free0, P, hash_fn=None):
        N, R = free0.shape
        self.layout = layout
        M = min(P, N)
        self.bits = 6
        while (1 << self.bits) < 4 * M:
            self.bits += 1
        self.table = [(-1, -1)] * (1 << self.bits)
        self.hash = hash_fn or (lambda c: ((c * 0x9E3779B1) & M32)
                                >> (32 - self.bits))
        self.rows = np.zeros((M, R), np.float32)
        self.slot_col = []
        self.free_after = free0.copy()
        self.bitmap = np.zeros(N, bool)
        self.probes = self.inserts = self.reuses = self.fast = 0

    def lookup(self, c):
        if not self.bitmap[c]:
            return -1
        if self.layout == "device":
            return c
        h = self.hash(c)
        while self.table[h][0] != c:
            self.probes += 1
            h = (h + 1) & ((1 << self.bits) - 1)
        return self.table[h][1]

    def row(self, c, slot):
        return (self.rows[slot] if self.layout == "shared"
                else self.free_after[c])

    def debit(self, c, slot, src, req):
        if slot >= 0:
            self.reuses += 1
        elif self.layout == "device":
            self.inserts += 1
            self.bitmap[c] = True
            slot = c
        else:
            self.inserts += 1
            self.bitmap[c] = True
            slot = len(self.slot_col)
            h = self.hash(c)
            while self.table[h][0] >= 0:
                h = (h + 1) & ((1 << self.bits) - 1)
            self.table[h] = (c, slot)
            self.slot_col.append(c)
        dst = self.row(c, slot)
        dst[:] = src - req  # one float32 subtraction per axis

    def write_back(self):
        for slot, c in enumerate(self.slot_col):
            self.free_after[c] = self.rows[slot]
        return self.free_after


def best_of(items):
    """(score, noise, column) of the best fitting item: largest score,
    then noise, then smallest column (-0.0 equals +0.0, as the keys)."""
    return max(items, key=lambda x: (float(x[0]), x[1], -x[2]),
               default=None)


def scan_model(scores, cand, kth, kthn, req, free0, seed, layout="shared",
               hash_fn=None, ring_k=128, stages=8):
    """csrc/shortlist_scan.cu step for step. Returns (chosen, assigned,
    free_after, repaired, overlay)."""
    P, N = scores.shape
    K = cand.shape[1]
    rk = min(K, ring_k)
    ov = Overlay(layout, free0, P, hash_fn)
    ring = [None] * stages
    chosen = np.full(P, -1, np.int32)
    assigned = np.zeros(P, bool)
    repaired = np.zeros(P, bool)
    for i in range(P):
        # The producers: pod i's candidates, scores, rows from free0, and
        # the best candidate by (score, noise, column), fit or not.
        c = cand[i]
        top = best_of([(scores[i, col], int(noise24(seed, i, col)), int(col),
                        kk) for kk, col in enumerate(c[:rk])])
        ring[i % stages] = (i, c[:rk].copy(), scores[i, c[:rk]],
                            free0[c[:rk]].copy(), top)
        pod, rc, rs, rrows, top = ring[i % stages]
        assert pod == i
        w = None
        if K == rk:  # the walker tries the best candidate first
            slot = ov.lookup(top[2])
            row = ov.row(top[2], slot) if slot >= 0 else rrows[top[3]]
            if (row >= req[i]).all():
                ov.fast += 1
                w = (top[0], top[1], top[2], slot, row.copy())
        if w is None:  # every candidate
            items = []
            for kk in range(K):
                col = int(c[kk])
                slot = ov.lookup(col)
                base = rrows[kk] if kk < rk else free0[col]
                row = ov.row(col, slot) if slot >= 0 else base
                if (row >= req[i]).all():
                    sc = rs[kk] if kk < rk else scores[i, col]
                    items.append((sc, int(noise24(seed, i, col)), col, slot,
                                  row.copy()))
            w = best_of(items)
        ok = w is not None and w[0] > NEG32
        cert = kth[i] <= NEG32
        if ok and not cert:
            wn = np.float32(w[1]) * np.float32(1.0 / (1 << 24))
            cert = w[0] > kth[i] or (w[0] == kth[i] and wn > kthn[i])
        if cert:
            if ok:
                ov.debit(w[2], w[3], w[4], req[i])
        else:  # the full row as free0 (+) overlay
            full = []
            for col in range(N):
                slot = ov.lookup(col)
                row = ov.row(col, slot) if slot >= 0 else free0[col]
                if (row >= req[i]).all():
                    full.append((scores[i, col],
                                 int(noise24(seed, i, col)), col, slot,
                                 row.copy()))
            w = best_of(full)
            ok = w is not None and w[0] > NEG32
            if ok:
                ov.debit(w[2], w[3], w[4], req[i])
        if ok:
            chosen[i], assigned[i] = w[2], True
        repaired[i] = not cert
    free_after = ov.write_back() if layout == "shared" else ov.free_after
    return chosen, assigned, free_after, repaired, ov


def _jax_select(scores, seed_key, k):
    return [np.asarray(x) for x in jselect(jnp.asarray(scores),
                                           seed_from_key(seed_key), k)]


def _keys(seed, counter):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), counter),
            prng.bits(prng.fold_in(prng.PRNGKey(seed), counter)))


def _select_rows(kind, rng, P=10, N=260):
    s = (rng.integers(0, 6, (P, N)) * 20.0).astype(np.float32)
    if kind == "plateau":
        s[:] = 100.0
    elif kind == "exact-tie":
        s[:, ::2] = 60.0
        s[:, 1::2] = 40.0
    elif kind == "neg":  # all-NEG rows among sparse ones
        s[rng.random((P, N)) < 0.6] = NEG
        s[[0, 3]] = NEG
    elif kind == "signed-zero":
        s[:] = np.where(rng.random((P, N)) < 0.5, 0.0, -0.0)
        for row in s:
            row[rng.choice(N, 3, replace=False)] = 5.0
    elif kind == "wide-p":  # P > K
        s = (rng.integers(0, 3, (40, 50)) * 1.0).astype(np.float32)
    return s


SELECT_KINDS = ["random", "plateau", "exact-tie", "neg", "signed-zero",
                "wide-p"]


@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("k", [1, 7, 128, "N"])
def test_select_model_matches_jax(kind, k):
    scores = _select_rows(kind, np.random.default_rng(len(kind)))
    k = scores.shape[1] if k == "N" else min(k, scores.shape[1])
    jkey, seed = _keys(7, k)
    want = _jax_select(scores, jkey, k)
    got = select_model(scores, seed, k)
    for w, g, name in zip(want, got, ("cand", "kth", "kth_noise")):
        assert bits_equal(w, g), name
    # The K-th composite key is always a boundary node's noise: never the
    # 2.0 of "above kth" nor the -1 of "below".
    assert ((want[2] >= 0) & (want[2] < 1)).all()


@pytest.mark.parametrize("name,P,N,R,seed,k,kw", SHORTLIST_CASES,
                         ids=[c[0] for c in SHORTLIST_CASES])
def test_select_model_on_shortlist_cases(name, P, N, R, seed, k, kw):
    scores = shortlist_case(P, N, R, seed, **kw)[0]
    k = min(k, N)
    jkey, tseed = _keys(seed, k)
    for w, g, f in zip(_jax_select(scores, jkey, k),
                       select_model(scores, tseed, k),
                       ("cand", "kth", "kth_noise")):
        assert bits_equal(w, g), f


def test_select_model_column_passes_on_forced_noise_ties():
    """Where many boundary nodes share the threshold noise, the kernel
    selects the lowest columns by digit passes over the column. Real
    noise rarely collides, so the model runs with a noise of 2 bits and
    is held against a sort by (class, noise desc, column asc)."""
    global noise24
    real = noise24
    noise24 = lambda seed, i, cols: (real(seed, i, cols) >> 22)  # noqa
    try:
        rng = np.random.default_rng(5)
        scores = (rng.integers(0, 2, (6, 700)) * 1.0).astype(np.float32)
        stats = {"column passes": 0}
        cand, kth, _ = select_model(scores, 99, 37, stats)
        for i in range(6):
            s = scores[i]
            nz = noise24(99, i, np.arange(700))
            cls = np.where(s > kth[i], 1 << 24, np.where(s == kth[i], nz, -1))
            want = sorted(range(700), key=lambda j: (-cls[j], j))[:37]
            assert list(cand[i]) == want
        # The list path cannot clear a floor with 2-bit noise: every row
        # takes the exact path and its column passes.
        assert stats["column passes"] == stats["exact"] == 6
    finally:
        noise24 = real


# The branch of the list path that each list-path row is built to take.
LIST_BRANCH = {"one-wider-than-k": "kth above L",
               "all-distinct": "kth above L",
               "top-exactly-k": "kth above L", "bench-like": "kth = L",
               "rebuilt": "rebuilt", "exact-after-overflow": "exact"}


@pytest.mark.parametrize("kind", SELECT_LIST_KINDS)
def test_select_model_list_path_branches(kind):
    """Rows aimed at each branch of the list path: a value held by K+1
    nodes, distinct values, exactly K nodes on top, bench-like plateaus
    (kth = L after one pass, the list about 1.5 K), a list rebuilt with
    exact counts, and one that overflows twice and takes the exact path."""
    scores, k = select_list_case(kind, np.random.default_rng(len(kind)))
    jkey, seed = _keys(3, k)
    want = _jax_select(scores, jkey, k)
    stats = {}
    got = select_model(scores, seed, k, stats)
    for w, g, name in zip(want, got, ("cand", "kth", "kth_noise")):
        assert bits_equal(w, g), name
    assert stats[LIST_BRANCH[kind]] == scores.shape[0], stats
    assert stats["list size"] <= CAP
    if kind == "bench-like":
        assert stats["list size"] < 2 * k


def test_select_model_takes_the_list_path_on_the_test_rows():
    """Every random, plateau and NEG row of the selection tests at K=128
    is served by the list path (no exact fallback; with one node per
    thread L is kth itself), and signed zeros at L go to the exact
    path."""
    stats = {}
    for kind in ("random", "plateau", "neg"):
        select_model(_select_rows(kind, np.random.default_rng(1)), 5, 128,
                     stats)
    assert stats["exact"] == 0 and stats["kth = L"] == 30
    stats = {}
    select_model(_select_rows("signed-zero", np.random.default_rng(7)), 5, 7,
                 stats)
    assert stats["signed-zero L"] == stats["exact"] > 0


def ports_model(state, rows, ports, order):
    """csrc/insert_ports.cu with its pods taken in ``order`` (any order:
    each pod reads only the input state and writes its own slots): a
    pod's prefix is the nonzero ports of the earlier pods on its row, and
    its ports fill that row's input zero slots from that rank on."""
    out = state.copy()
    N = state.shape[0]
    cnt = (ports != 0).sum(axis=1)
    for i in order:
        r = int(rows[i])
        if r < 0 or r >= N:
            continue
        prefix = int(cnt[:i][rows[:i] == r].sum())
        mine = [int(p) for p in ports[i] if p]
        zeros = np.flatnonzero(state[r] == 0)[prefix:prefix + len(mine)]
        out[r, zeros] = mine[:len(zeros)]
    return out


@pytest.mark.parametrize("kind", PORTS_DESIGN_KINDS)
def test_ports_model_matches_jax(kind):
    state, rows, ports = ports_design_case(kind, np.random.default_rng(9))
    want = np.asarray(JR.insert_ports(jnp.asarray(state), rows, ports))
    P = rows.shape[0]
    for order in (range(P), range(P - 1, -1, -1),
                  np.random.default_rng(1).permutation(P)):
        assert bits_equal(want, ports_model(state, rows, ports, order))
    assert not bits_equal(want, state)
    if kind == "full-rows":  # some ports dropped
        assert (want != state).sum() < (ports[rows >= 0] != 0).sum()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ports_model_on_ports_cases(seed):
    state, rows, ports = ports_case(np.random.default_rng(seed))
    want = np.asarray(JR.insert_ports(jnp.asarray(state), rows, ports))
    got = ports_model(state, rows, ports,
                      np.random.default_rng(seed).permutation(len(rows)))
    assert bits_equal(want, got)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 13, 64, 100, 128, 129])
def test_bitonic_network_sorts_any_length(n):
    keys = list(np.random.default_rng(n).integers(0, 50, n))
    assert bitonic_desc(keys) == sorted(keys, reverse=True)


def _scan_case(name, P, N, R, seed, k, kw):
    scores, req, free = shortlist_case(P, N, R, seed, **kw)
    jkey, tseed = _keys(seed, k)
    k = min(k, N)
    cand, kth, kthn = _jax_select(scores, jkey, k)
    want = jshortlist(scores, req, free, jkey, k=k)
    return (scores, cand, kth, kthn, req, free, tseed), want


@pytest.mark.parametrize("layout", ["shared", "device"])
@pytest.mark.parametrize("name,P,N,R,seed,k,kw", SHORTLIST_CASES,
                         ids=[c[0] for c in SHORTLIST_CASES])
def test_scan_model_matches_jax(layout, name, P, N, R, seed, k, kw):
    args, want = _scan_case(name, P, N, R, seed, k, kw)
    got = scan_model(*args, layout=layout)
    for g, f in zip(got[:4], ("chosen", "assigned", "free_after",
                              "repaired")):
        assert bits_equal(np.asarray(getattr(want, f)), g), f


@pytest.mark.parametrize("hash_name", ["constant", "two-buckets"])
def test_scan_model_with_forced_collisions(hash_name):
    """Every column hashes to one or two buckets: long probe chains,
    slots reused by columns debited twice, the write-back of every
    slot. Held against JAX on the contention case (repairs) and a
    scarce case."""
    fn = {"constant": lambda c: 0, "two-buckets": lambda c: 5 * (c & 1)}
    for case in (("contention", 128, 512, 3, 3, 8, {"contend": True}),
                 ("random", 96, 384, 3, 1, 16, {})):
        args, want = _scan_case(*case)
        got = scan_model(*args, hash_fn=fn[hash_name])
        for g, f in zip(got[:4], ("chosen", "assigned", "free_after",
                                  "repaired")):
            assert bits_equal(np.asarray(getattr(want, f)), g), f
        ov = got[4]
        assert ov.probes > 10 and ov.reuses > 0 and ov.inserts > 10
        assert 0 < ov.fast < len(got[0])


@pytest.mark.parametrize("layout", ["shared", "device"])
@pytest.mark.parametrize("stages,ring_k", [(2, 128), (3, 5), (8, 1)])
def test_scan_model_ring_shapes(layout, stages, ring_k):
    """Any ring depth, and candidates past the ring read from free0 (the
    kernel's K > 128 path), on a scarce case where consecutive pods want
    the same nodes."""
    rng = np.random.default_rng(stages * 10 + ring_k)
    scores, req, free = scarce_case(rng, 64, 300, R=4)
    jkey, tseed = _keys(3, ring_k)
    cand, kth, kthn = _jax_select(scores, jkey, 24)
    want = jshortlist(scores, req, free, jkey, k=24)
    got = scan_model(scores, cand, kth, kthn, req, free, tseed,
                     layout=layout, ring_k=ring_k, stages=stages)
    for g, f in zip(got[:4], ("chosen", "assigned", "free_after",
                              "repaired")):
        assert bits_equal(np.asarray(getattr(want, f)), g), f
    assert got[1].sum() > 20


@pytest.mark.parametrize("kind", ["exact-tie", "plateau"])
@pytest.mark.parametrize("k", [1, 7, "N"])
def test_scan_model_on_tied_rows(kind, k):
    """Scores tied far past K (the exact-tie and plateau rows of the
    selection tests) with P > K: the boundary decides the shortlist, the
    best candidate is a noise pick, and repairs follow debits."""
    rng = np.random.default_rng(len(kind))
    scores = _select_rows(kind, rng, P=48, N=120)
    req = (rng.integers(1, 4, (48, 3)) * 0.25).astype(np.float32)
    free = (rng.integers(1, 4, (120, 3)) * 0.5).astype(np.float32)
    k = scores.shape[1] if k == "N" else k
    jkey, tseed = _keys(5, k)
    cand, kth, kthn = _jax_select(scores, jkey, k)
    want = jshortlist(scores, req, free, jkey, k=k)
    got = scan_model(scores, cand, kth, kthn, req, free, tseed)
    for g, f in zip(got[:4], ("chosen", "assigned", "free_after",
                              "repaired")):
        assert bits_equal(np.asarray(getattr(want, f)), g), f
    assert got[1].sum() > 10


@pytest.mark.parametrize("k", [12, 150])
def test_scan_model_signed_zero_scores(k):
    """Scores of +0.0 and -0.0 tie in the scan (float compare) while the
    selection's kth keeps JAX's sign (+0.0 at K=12, -0.0 at K=150, past
    the row's +0.0 nodes): certified steps and the full-row repair agree
    with JAX."""
    rng = np.random.default_rng(11)
    scores, req, free = shortlist_case(64, 200, 3, 11)
    scores[:] = np.where(rng.random(scores.shape) < 0.5, 0.0, -0.0)
    scores[:, ::25] = 1.0
    jkey, tseed = _keys(11, k)
    cand, kth, kthn = _jax_select(scores, jkey, k)
    assert (kth == 0).all() and np.signbit(kth).all() == (k == 150)
    want = jshortlist(scores, req, free, jkey, k=k)
    got = scan_model(scores, cand, kth, kthn, req, free, tseed)
    for g, f in zip(got[:4], ("chosen", "assigned", "free_after",
                              "repaired")):
        assert bits_equal(np.asarray(getattr(want, f)), g), f
    assert got[1].sum() > 20
