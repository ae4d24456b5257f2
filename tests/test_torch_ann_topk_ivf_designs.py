"""The designs of the routed bucket scans, kernels 3 and 4
(``ann_topk_ivf`` / ``ann_topk_ivf_quant``) and kernel 5, the shard-owned
scans (``ann_topk_ivf_sharded`` / ``ann_topk_ivf_quant_sharded``): which
inputs take one warp per probe ("warp") and which the grouped bucket scan
("grouped") under their one ``pick_design`` ("block" and "chunked" stay
launchable, and no dispatch takes them), the counts by design, the C
entry points' ctypes signatures and launch arguments, and a CPU rehearsal
of the warp design's selection (``csrc/ann_topk_ivf.cu::warp_probe`` and
its two writers, ``ivf_warp`` and ``ivf_warp_sharded``).

The CUDA kernels run only on the card, where chip_smoke.py holds both
designs to the plain versions. The rehearsal repeats the warp kernels'
steps in numpy: two scores a lane (slots lane and lane + 32), NEG for
invalid slots and for the stable sort's pads past cap, a bitonic network
in ``ranks_before`` order over the first max(valid prefix, k) entries (8,
16 or 32 lanes, or all 64 entries); the unsharded writer stores the first
k lanes' (value, slot) pairs, and NEG at slots 0 .. k - 1 for a probe it
did not scan; the sharded one finds the owner with one ballot over the cut
points, maps the finalists to global rows and writes them at the owner.
Each must give its plain version's output exactly, ties and NEG entries
included. Scores come from integer-valued rows, so every summation order
gives the same fp32 sums, and the int8 rescale repeats the reference's two
rounded multiplies.
"""
import contextlib
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ann_topk_ivf as ivf
from repro_torch.kernels import ann_topk_sharded as sh
from repro_torch.kernels.ann_topk import K_MAX, NEG

torch.set_num_threads(1)

INT_MAX = 2**31 - 1


# ------------------------------------------------------------ dispatch

@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("k", [1, 4, 16, 32, 64])
@pytest.mark.parametrize("cap", [8, 16, 32, 64, 128, 4096])
def test_design_by_bucket_size(cap, k, quant):
    """Buckets of at most 64 slots take "warp" at every k, whatever the
    payload type (the engine's caps, powers of two from 8); larger ones,
    the real-size router's, take "grouped" in kernel 5 as in kernels 3
    and 4."""
    want = "warp" if cap <= 64 else "grouped"
    assert sh.pick_design(cap, k, 128, quant) == want


@pytest.mark.parametrize("quant", [False, True])
def test_design_falls_back_where_the_queries_overflow_shared_memory(quant):
    """"warp" keeps each of its warps' queries in shared memory: a width
    that overflows it takes "grouped", which reads a query too wide for
    its shared memory in place."""
    item = 1 if quant else 4
    d_max = (sh.SMEM_MAX // sh.WARP_PROBES - K_MAX * 8 - sh.WARP_CAP * 4) \
        // item // 16 * 16
    assert sh.warp_smem(d_max, quant) <= sh.SMEM_MAX
    assert sh.pick_design(16, 4, d_max, quant) == "warp"
    assert sh.pick_design(16, 4, d_max + 16, quant) == "grouped"


def test_designs_are_named_by_the_counts():
    """Each design has its count on both wrappers, starting at 0 in a fresh
    process and never touched by the CPU path; ``_launch`` refuses a
    design it does not know before it touches the card."""
    assert sh.DESIGNS == ("warp", "grouped", "block", "chunked")
    for w in (sh.ann_topk_ivf_sharded, sh.ann_topk_ivf_quant_sharded):
        for d in sh.DESIGNS:
            assert isinstance(getattr(w, f"launches_{d}"), int)
        assert isinstance(w.launches, int)
    with pytest.raises(ValueError, match="design"):
        sh._launch("tile", sh.ann_topk_ivf_sharded, k=4)


def test_cpu_calls_leave_the_design_counts_alone():
    sel, en, q, buckets, valid, rows, bounds = _inputs(16, 8, 2, 3, 8,
                                                       0.5, [0, 3, 8],
                                                       seed=0)
    w = sh.ann_topk_ivf_sharded
    before = (w.launches, w.launches_warp, w.launches_block, w.plain_calls)
    w(*(torch.from_numpy(x) for x in (sel, en, q, buckets, valid, rows,
                                      bounds)), 4)
    assert (w.launches, w.launches_warp, w.launches_block) == before[:3]
    assert w.plain_calls == before[3] + 1


# ---------------------------------- one dispatch for kernels 3, 4 and 5

WRAPPERS = (ivf.ann_topk_ivf, ivf.ann_topk_ivf_quant,
            sh.ann_topk_ivf_sharded, sh.ann_topk_ivf_quant_sharded)
COUNTS = ("launches", "launches_warp", "launches_grouped", "launches_block",
          "launches_chunked", "plain_calls")


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("k", [1, 4, 16, 32, 64])
@pytest.mark.parametrize("cap", [8, 16, 32, 64, 128, 4096])
def test_unsharded_design_by_bucket_size(cap, k, quant):
    """Kernels 3 and 4 take "warp" for buckets of at most 64 slots at
    every k, as kernel 5 does, and "grouped" for larger ones, as kernel 5
    does."""
    small = cap <= 64
    assert ivf.pick_design(cap, k, 128, quant, sharded=False) == \
        ("warp" if small else "grouped")
    assert sh.pick_design(cap, k, 128, quant, sharded=True) == \
        ("warp" if small else "grouped")


def _old_kernel_5_rule(cap, k, d, quant):
    """Kernel 5's dispatch before it took "grouped": "warp", else "block"
    where the bucket's scores and the query fit shared memory, else
    "chunked"."""
    if cap <= ivf.WARP_CAP and k <= K_MAX \
            and ivf.warp_smem(d, quant, True) <= ivf.SMEM_MAX:
        return "warp"
    return "block" if ivf.block_smem(cap, d, k, quant, True) <= \
        ivf.SMEM_MAX else "chunked"


@pytest.mark.parametrize("quant", [False, True])
def test_kernel_5_takes_grouped_wherever_it_took_block_or_chunked(quant):
    """Over caps, k and widths on both sides of every limit: kernel 5
    takes "warp" exactly where it did, and "grouped" wherever it took
    "block" or "chunked" (both of which the grid reaches)."""
    seen = set()
    for cap in (8, 64, 65, 100, 4096, 57000, 65536, 2**20):
        for k in (1, 16, 64, 65, 6000):
            for d in (16, 768, 14000, 60000):
                old = _old_kernel_5_rule(cap, k, d, quant)
                seen.add(old)
                new = sh.pick_design(cap, k, d, quant, sharded=True)
                assert new == ("warp" if old == "warp" else "grouped"), \
                    (cap, k, d, old, new)
    assert seen == {"warp", "block", "chunked"}


def test_kernel_5_resolves_the_same_dispatch():
    """ann_topk_sharded's names are the unsharded module's own objects:
    one rule, one launcher, one set of limits."""
    for name in ("pick_design", "warp_smem", "_launch", "DESIGNS",
                 "WARP_CAP", "WARP_PROBES", "SMEM_MAX"):
        assert getattr(sh, name) is getattr(ivf, name)
    assert ivf.DESIGNS == ("warp", "grouped", "block", "chunked") \
        and ivf.WARP_CAP == 64


@pytest.mark.parametrize("quant", [False, True])
def test_unsharded_writer_needs_only_the_queries_shared_memory(quant):
    """The unsharded writer stores its finalists from registers: its CTA
    holds only its warps' queries, so it keeps "warp" up to a wider D than
    the sharded writer."""
    item = 1 if quant else 4
    d_max = ivf.SMEM_MAX // ivf.WARP_PROBES // item // 16 * 16
    assert ivf.warp_smem(d_max, quant, sharded=False) == \
        ivf.WARP_PROBES * d_max * item <= ivf.SMEM_MAX
    assert ivf.warp_smem(d_max, quant, sharded=False) < \
        ivf.warp_smem(d_max, quant, sharded=True)
    assert ivf.pick_design(16, 4, d_max, quant, sharded=False) == "warp"
    assert ivf.pick_design(16, 4, d_max, quant, sharded=True) == "grouped"
    assert ivf.pick_design(16, 4, d_max + 16, quant, sharded=False) == \
        "grouped"


def test_every_routed_scan_counts_by_design():
    """All four wrappers carry the same counts, one for every design,
    kernel 5's "grouped" among them; ``_launch`` refuses a design it does
    not know before it touches the card."""
    assert COUNTS[1:-1] == tuple(f"launches_{d}" for d in ivf.DESIGNS)
    for w in WRAPPERS:
        for name in COUNTS:
            assert isinstance(getattr(w, name), int), (w.__name__, name)
    with pytest.raises(ValueError, match="design"):
        ivf._launch("tile", ivf.ann_topk_ivf, k=4)


def test_cpu_calls_of_the_unsharded_scans_leave_the_launch_counts_at_0():
    c, cap, d = 8, 16, 16
    sel, en, q, buckets, valid, _, _ = _inputs(cap, d, 2, 3, c, 0.5,
                                               [0, c], seed=1)
    sel = np.clip(sel, 0, c - 1)
    (qq, qs, bq, bs) = _scored(sel, q, buckets, quant=True)[1]
    t = torch.from_numpy
    before = [w.plain_calls for w in WRAPPERS]
    ivf.ann_topk_ivf(t(sel), t(en), t(q), t(buckets), t(valid), 4)
    ivf.ann_topk_ivf_quant(t(sel), t(en), t(qq), t(qs), t(bq), t(bs),
                           t(valid), 16)
    for w in WRAPPERS:
        assert (w.launches, w.launches_warp, w.launches_grouped,
                w.launches_block) == (0, 0, 0, 0)
    assert [w.plain_calls for w in WRAPPERS] == \
        [before[0] + 1, before[1] + 1, before[2], before[3]]


ENTRY_POINTS = ("ann_topk_ivf_launch", "ann_topk_ivf_quant_launch",
                "ann_topk_ivf_sharded_launch",
                "ann_topk_ivf_quant_sharded_launch",
                "ann_topk_ivf_chunked_launch", "ann_topk_ivf_grouped_launch",
                "ann_topk_ivf_error_string")


def _c_signatures() -> dict:
    """Each extern "C" function of csrc/ann_topk_ivf.cu: its parameters
    as "p" (a pointer) or "i" (an int)."""
    src = (Path(ivf.__file__).parent / "csrc" / "ann_topk_ivf.cu").read_text()
    body = src[src.index('extern "C" {'):]
    return {m.group(1): ["i" if x.strip().startswith("int ") else "p"
                         for x in m.group(2).split(",")]
            for m in re.finditer(r"^(?:int|const char\*) (\w+)\(([^)]*)\)",
                                 body, re.M)}


class _FakeEntry:
    """A C entry point that records its calls and returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


def _fake_lib(monkeypatch, err=0):
    lib = types.SimpleNamespace(**{n: _FakeEntry(err) for n in ENTRY_POINTS})
    lib.ann_topk_ivf_error_string = lambda e: b"invalid argument"
    lib.ann_topk_ivf_error_string.argtypes = None
    monkeypatch.setattr(ivf.build, "load", lambda name: lib)
    return lib


def test_ctypes_signatures_match_the_c_entry_points(monkeypatch):
    """``_lib`` types every entry point as the source declares it (a stale
    list would pass garbage without an error)."""
    lib = _fake_lib(monkeypatch)
    assert ivf._lib() is lib
    sigs = _c_signatures()
    assert set(sigs) == set(ENTRY_POINTS)
    kind = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for name, params in sigs.items():
        assert getattr(lib, name).argtypes == [kind[x] for x in params], name
    # every launcher takes its design code just before its outputs
    for name in ENTRY_POINTS[:4]:
        assert sigs[name][-5:] == ["i", "i", "p", "p", "p"], name
    # "chunked" and "grouped" take every scan: the dtype, the inputs with
    # the shard-owned scans' bucket_rows and bounds (null for the others),
    # then S and the shape
    for name in ENTRY_POINTS[4:6]:
        assert sigs[name][:12] == ["i"] + ["p"] * 9 + ["i"] * 2, name
    assert len(sigs["ann_topk_ivf_grouped_launch"]) == 1 + 9 + 11 + 8


def _routed_args(which: str):
    """Small CPU inputs of one wrapper, in its argument order."""
    c, cap, d, b, nprobe = 8, 16, 32, 2, 3
    sel, en, q, buckets, valid, rows, bounds = _inputs(
        cap, d, b, nprobe, c, 0.5, [0, 3, 8], seed=2)
    sel = np.clip(sel, 0, c - 1)
    payload = _scored(sel, q, buckets, quant="quant" in which)[1]
    tail = (valid, rows, bounds) if "sharded" in which else (valid,)
    t = torch.from_numpy
    return tuple(t(x) for x in (sel, en, *payload, *tail))


@pytest.mark.parametrize("design", ["warp", "block"])
@pytest.mark.parametrize("wrapper", WRAPPERS, ids=lambda w: w.__name__)
def test_launch_passes_the_shape_and_the_design_code(monkeypatch, wrapper,
                                                     design):
    """``_launch`` hands each C entry point its input pointers in the
    wrapper's order, then (S,) B, nprobe, C, cap, D, k and the design's
    code, then the fresh outputs and the stream; and counts the design."""
    lib = _fake_lib(monkeypatch)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=77))
    for w in WRAPPERS:
        for name in COUNTS:
            monkeypatch.setattr(w, name, 0)
    args = _routed_args(wrapper.__name__)
    sharded = wrapper.__name__.endswith("_sharded")
    vals, idx = ivf._launch(design, wrapper, *args, k=4)
    (call,) = getattr(lib, f"{wrapper.__name__}_launch").calls
    n = len(args)
    assert call[:n] == tuple(x.data_ptr() for x in args)
    sel, buckets = args[0], args[4 if "quant" in wrapper.__name__ else 3]
    lead = (args[-1].numel() - 1,) if sharded else ()
    assert call[n:-3] == (*lead, *sel.shape, *buckets.shape, 4,
                          {"block": 0, "warp": 1}[design])
    assert call[-3:] == (vals.data_ptr(), idx.data_ptr(), 77)
    assert vals.shape == idx.shape == (*lead, *sel.shape, 4)
    assert (vals.dtype, idx.dtype) == (torch.float32, torch.int32)
    other = "block" if design == "warp" else "warp"
    assert (wrapper.launches, getattr(wrapper, f"launches_{design}"),
            getattr(wrapper, f"launches_{other}")) == (1, 1, 0)


def test_failed_launch_names_the_shape_and_the_design(monkeypatch):
    _fake_lib(monkeypatch, err=1)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ivf.ann_topk_ivf_quant, "launches", 0)
    with pytest.raises(RuntimeError,
                       match=r"ann_topk_ivf_quant launch failed .*cap=16 "
                             r"d=32 k=16 design=warp"):
        ivf._launch("warp", ivf.ann_topk_ivf_quant,
                    *_routed_args("ann_topk_ivf_quant"), k=16)
    assert ivf.ann_topk_ivf_quant.launches == 0


# ---------------------------------------- the warp design's selection

def _ranks_before(a, ra, b, rb):
    return a > b or (a == b and ra < rb)


def _network(v, r, e, n):
    """select.cuh::warp_sort_regs<E, N>, lane by lane: entry lane + 32 j in
    v[lane][j]; only the first log2(n) merges run. Returns the entries in
    index order."""
    v = [row[:] for row in v]
    r = [row[:] for row in r]
    size = 2
    while size <= n:
        stride = size >> 1
        while stride > 0:
            if stride == 32:
                for lane in range(32):
                    if _ranks_before(v[lane][1], r[lane][1], v[lane][0],
                                     r[lane][0]):
                        v[lane].reverse()
                        r[lane].reverse()
            else:
                nv = [row[:] for row in v]
                nr = [row[:] for row in r]
                for lane in range(32):
                    for j in range(e):
                        el = lane + 32 * j
                        ov, orow = v[lane ^ stride][j], r[lane ^ stride][j]
                        first = ((el & stride) == 0) == ((el & size) == 0)
                        if first == _ranks_before(ov, orow, v[lane][j],
                                                  r[lane][j]):
                            nv[lane][j], nr[lane][j] = ov, orow
                v, r = nv, nr
            stride >>= 1
        size <<= 1
    return ([v[i % 32][i // 32] for i in range(32 * e)],
            [r[i % 32][i // 32] for i in range(32 * e)])


def _best_of_few(score, m, k):
    """select.cuh::warp_best_of_few(m, k, ..., tight=true): entry i is
    (score[i], i) for i < m, (-inf, INT_MAX) past it; a network over 8 or
    16 lanes for m <= 8 / 16, all 32 for m <= 32, both halves above."""
    e = 1 if m <= 32 else 2
    n = 32 * e if m > 16 else (8 if m <= 8 else 16)
    v = [[score[lane + 32 * j] if lane + 32 * j < m else -np.inf
          for j in range(e)] for lane in range(32)]
    r = [[lane + 32 * j if lane + 32 * j < m else INT_MAX
          for j in range(e)] for lane in range(32)]
    vals, slots = _network(v, r, e, n)
    return vals[:k], slots[:k]


def _warp_probe(c, scores, valid, k):
    """warp_probe on host arrays for one enabled probe of bucket ``c``:
    ``scores`` (cap,) its raw scores (what score_groups and Scorer::finish
    give). Returns the k finalists' values and slots."""
    cap = valid.shape[1]
    ok = valid[c].astype(bool)
    hi = int(np.nonzero(ok)[0].max()) + 1 if ok.any() else 0
    # two slots a lane: entry i is slot i, NEG where invalid and past cap
    # (the stable sort's pads up to k)
    score = [float(scores[i]) if i < cap and ok[i]
             else float(np.float32(NEG)) for i in range(64)]
    return _best_of_few(score, max(hi, k), k)


def _scanned(sel, en, valid, bi, j):
    c = int(sel[bi, j])
    return en[bi, j] != 0 and 0 <= c < valid.shape[0]


def _warp_unsharded(sel, en, scores, valid, k):
    """ivf_warp on host arrays: ``scores`` (B, nprobe, cap) the probes' raw
    scores. Returns the (B, nprobe, k) vals and slots."""
    b, nprobe = sel.shape
    vals = np.full((b, nprobe, k), np.float32(NEG), np.float32)
    slots = np.tile(np.arange(k, dtype=np.int32), (b, nprobe, 1))
    for bi in range(b):
        for j in range(nprobe):
            if _scanned(sel, en, valid, bi, j):
                vals[bi, j], slots[bi, j] = _warp_probe(
                    int(sel[bi, j]), scores[bi, j], valid, k)
    return vals, slots


def _warp_kernel(sel, en, scores, valid, rows, bounds, k):
    """ivf_warp_sharded on host arrays: ``scores`` (B, nprobe, cap) the
    probes' raw scores. Returns the (S, B, nprobe, k) stacks."""
    b, nprobe = sel.shape
    s_count = len(bounds) - 1
    vals = np.full((s_count, b, nprobe, k), np.float32(NEG), np.float32)
    out_rows = np.full((s_count, b, nprobe, k), -1, np.int32)
    for bi in range(b):
        for j in range(nprobe):
            c = int(sel[bi, j])
            if not _scanned(sel, en, valid, bi, j):
                continue
            own = [s for s in range(s_count)
                   if bounds[s] <= c < bounds[s + 1]]
            if not own:
                continue
            fv, fs = _warp_probe(c, scores[bi, j], valid, k)
            for p in range(k):
                vals[own[0], bi, j, p] = fv[p]
                if fv[p] > NEG / 2:
                    out_rows[own[0], bi, j, p] = rows[c, fs[p]]
    return vals, out_rows


def _inputs(cap, d, b, nprobe, c, p_valid, bounds, seed):
    """Integer-valued buckets (exact fp32 sums in any order) with duplicate
    rows inside buckets (exact ties), a random valid mask at share
    p_valid, distinct global rows ascending within a bucket, queries and
    probes (a share of them disabled, one out of range)."""
    rng = np.random.default_rng(seed)
    buckets = rng.integers(-3, 4, (c, cap, d)).astype(np.float32)
    for ci in range(c):
        src = rng.integers(0, cap)
        buckets[ci, rng.integers(0, cap, 3)] = buckets[ci, src]
    valid = (rng.random((c, cap)) < p_valid).astype(np.uint8)
    rows = np.sort(rng.choice(4 * c * cap, (c, cap), replace=False), axis=1)
    rows = np.where(valid > 0, rows, -1).astype(np.int32)
    q = rng.integers(-3, 4, (b, d)).astype(np.float32)
    sel = np.stack([rng.choice(c, nprobe, replace=False)
                    for _ in range(b)]).astype(np.int32)
    en = (rng.random((b, nprobe)) >= 0.2).astype(np.int32)
    sel[0, 0] = c          # out of range: scores as a disabled probe
    return (sel, en, q, buckets, valid, rows,
            np.asarray(bounds, np.int32))


def _quantize(x):
    amax = np.abs(x).max(axis=-1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    xq = np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8)
    return xq, scale


def _scored(sel_c, q, buckets, quant):
    """The probes' raw scores (B, nprobe, cap) as the kernels compute
    them, for in-range ``sel_c``, and the plain versions' payload: (q,
    buckets) fp32, or (qq, q_scales, buckets_q, bucket_scale) int8."""
    c, cap, d = buckets.shape
    if not quant:
        return (np.einsum("bjsd,bd->bjs", buckets[sel_c], q).astype(
            np.float32), (q, buckets))
    bq, bs = _quantize(buckets.reshape(c * cap, d))
    bq, bs = bq.reshape(c, cap, d), bs.reshape(c, cap)
    qq, qs = _quantize(q)
    dots = np.einsum("bjsd,bd->bjs", bq[sel_c].astype(np.int32),
                     qq.astype(np.int32))
    # float(i32) * slot scale, then * query scale, each rounded
    scores = (dots.astype(np.float32) * bs[sel_c]).astype(np.float32) \
        * qs[:, None, None]
    return scores.astype(np.float32), (qq, qs, bq, bs)


# bounds over C = 8 clusters: one shard; three with an empty one; eight,
# two of them empty
BOUNDS = {1: [0, 8], 3: [0, 3, 3, 8], 8: [0, 1, 1, 2, 4, 5, 5, 7, 8]}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("p_valid", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("cap", [8, 16, 32, 64])
def test_warp_selection_is_the_plain_stable_top_k(cap, k, p_valid, s, quant):
    """The rehearsal gives the plain version's stacks exactly: values,
    global rows, NEG / -1 at every masked entry, exact ties in slot
    order, k above cap."""
    c, d, b, nprobe = 8, 16, 2, 4
    sel, en, q, buckets, valid, rows, bounds = _inputs(
        cap, d, b, nprobe, c, p_valid, BOUNDS[s], seed=cap * 100 + k)
    t = torch.from_numpy
    scores, payload = _scored(np.clip(sel, 0, c - 1), q, buckets, quant)
    plain = (sh.ann_topk_ivf_quant_sharded_plain if quant
             else sh.ann_topk_ivf_sharded_plain)
    want = plain(t(sel), t(en), *map(t, payload), t(valid), t(rows),
                 t(bounds), k)
    got = _warp_kernel(sel, en, scores, valid, rows, bounds, k)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("p_valid", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("cap", [8, 16, 32, 64])
def test_unsharded_warp_writer_is_the_plain_stable_top_k(cap, k, p_valid,
                                                         quant):
    """The unsharded writer's rehearsal gives kernels 3 and 4's plain
    versions exactly: values and slots, the slots of NEG entries included
    (invalid slots in ascending order, then the pads past cap, and 0 .. k
    - 1 for a disabled probe), exact ties in slot order, k above cap. A
    probe out of range scans as a disabled one."""
    c, d, b, nprobe = 8, 16, 3, 4
    sel, en, q, buckets, valid, _, _ = _inputs(
        cap, d, b, nprobe, c, p_valid, BOUNDS[1], seed=cap * 100 + k + 7)
    sel_c = np.clip(sel, 0, c - 1)
    scores, payload = _scored(sel_c, q, buckets, quant)
    got = _warp_unsharded(sel, en, scores, valid, k)
    t = torch.from_numpy
    plain = ivf.ann_topk_ivf_quant_plain if quant else ivf.ann_topk_ivf_plain
    want = plain(t(sel_c), t(np.where(sel < c, en, 0).astype(np.int32)),
                 *map(t, payload), t(valid), k)
    assert (want[0].numpy() <= NEG / 2).any()
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("m,k", [(1, 1), (5, 4), (8, 8), (9, 4), (16, 16),
                                 (17, 16), (32, 4), (33, 16), (64, 16),
                                 (64, 64)])
def test_tight_network_sorts_its_first_lanes(m, k):
    """The network cut to the next 8, 16 or 32 lanes (or both halves of
    64 entries) puts the first k of m entries in ranks_before order, exact
    value ties in index order, as the full 32-lane network does."""
    rng = np.random.default_rng(m * 7 + k)
    score = rng.integers(-3, 4, 64).astype(np.float32).tolist()
    vals, slots = _best_of_few(score, m, k)
    want = sorted(range(m), key=lambda i: (-score[i], i))[:k]
    assert slots == want
    assert vals == [score[i] for i in want]
