"""Which paged-attention kernel serves which call, and the arithmetic the
tensor-core design rests on, on the CPU.

``ops.paged_attention.ROUTES`` maps (q dtype, cache kind) to an
instantiation of the one kernel design, ``mma`` (``csrc/paged_attention_mma.cu``:
bf16 q over a bf16, int8 or packed-int4 cache; f32 q over an f32, int8 or
packed-int4 cache). The kernel runs only on the card, where
``chip_smoke.py`` holds it against the plain version; here the route table,
the input checks, the split count and the exactness argument of the design
are checked:
- int8 and int4 values widen to bf16 exactly (|x| <= 127 fits bf16's 8-bit
  significand), including through the kernel's bit tricks;
- P enters the MMA as p_hi + p_lo, both bf16: the product with int8 or
  bf16 V then equals the f32 product to 2^-16 of sum |p v| (p alone as
  bf16 errs by up to 2^-9 a weight);
- f32 q: an f32 splits exactly into three bf16 terms (round to nearest
  even, as ``__float2bfloat16_rn``), each partial product of a term with
  an int8 or int4 value is exact, and the three sum to the exact product
  (two terms do not); summed in f32 a k-step of 16 at a time, as the MMA
  sums, scores and p.v stay within chip_smoke.py's f32 limit
  (2e-5 |ref| + 2e-5) of the f64 reference at the decode shape;
- f32 q over the f32 cache: K and V split three ways too, six of the nine
  term products kept (the three dropped are each at most 2^-24 of |q||k|),
  the kernel's fragment layout covers each product once, and the emulated
  k-steps stay within the f32 limit at the decode and D=16 shapes;
- q scaled by D^-0.5 as either kernel loads it (bf16 or f32) has the bits
  of the wrapper's ``scale_query``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops import paged_attention as tpa

PAIRS = {
    (torch.bfloat16, "float"): ("mma_bf16", "mma"),
    (torch.bfloat16, "int8"): ("mma_int8", "mma"),
    (torch.bfloat16, "int4"): ("mma_int4", "mma"),
    (torch.float32, "float"): ("mma_f32", "mma"),
    (torch.float32, "int8"): ("mma_int8_f32q", "mma"),
    (torch.float32, "int4"): ("mma_int4_f32q", "mma"),
}
KINDS = ["float", "int8", "int4"]
QUANT = ["int8", "int4"]


@pytest.mark.parametrize("pair", list(PAIRS), ids=lambda p: f"{p[0]}-{p[1]}")
def test_route_table(pair):
    route, design = PAIRS[pair]
    assert tpa.ROUTES[pair] == route and route.split("_", 1)[0] == design
    assert set(tpa.ROUTES) == set(PAIRS)
    tpa.reset_launches()
    assert tpa.paged_attention.launches_by_kernel == dict.fromkeys(tpa.ROUTE_KERNELS, 0)
    assert route in tpa.ROUTE_KERNELS


def _inputs(q_dtype, kind, d, bs, kh=2, h=4, b=2, nblk=3, nb=8):
    q = torch.zeros((b, 1, h, d), dtype=q_dtype)
    dp = d // 2 if kind == "int4" else d
    payload = torch.uint8 if kind == "int4" else torch.int8

    def cache():
        if kind == "float":
            return torch.zeros((nb, bs, kh, d), dtype=q_dtype)
        return {"q": torch.zeros((nb, bs, kh, dp), dtype=payload),
                "s": torch.ones((nb, kh), dtype=torch.float32)}

    bt = torch.arange(1, 1 + b * nblk, dtype=torch.int32).reshape(b, nblk)
    qs = torch.zeros((b,), dtype=torch.int32)
    return q, cache(), cache(), bt, qs, qs + 1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d,bs", [(24, 16), (40, 16), (16, 8), (64, 24)])
def test_mma_route_refuses_shapes_it_does_not_take(kind, d, bs):
    """Every route, bf16 or f32 q over any cache, needs D and BS multiples
    of 16 and raises otherwise (there is no other route to take it)."""
    for q_dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="multiples of 16"):
            tpa._check_cuda_inputs(*_inputs(q_dtype, kind, d, bs))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d,bs", [(16, 16), (64, 16), (128, 16), (128, 32), (256, 16)])
def test_mma_route_takes_its_shapes(kind, d, bs):
    """bf16 q and f32 q over every cache."""
    for q_dtype in (torch.bfloat16, torch.float32):
        tpa._check_cuda_inputs(*_inputs(q_dtype, kind, d, bs))


def _offset_view(x: torch.Tensor, elems: int) -> torch.Tensor:
    """A contiguous view of a copy of ``x`` that starts ``elems`` elements
    into its storage."""
    flat = torch.zeros(x.numel() + elems, dtype=x.dtype)
    return flat[elems:].view(x.shape)


@pytest.mark.parametrize("kind", KINDS)
def test_mma_route_refuses_a_misaligned_query(kind):
    """The kernel reads q in 4- and 8-byte vectors: a contiguous q at a
    storage offset off 16 bytes raises instead of faulting on the card, f32
    q as bf16 q, over every cache."""
    q, *rest = _inputs(torch.bfloat16, kind, 128, 16)
    tpa._check_cuda_inputs(_offset_view(q, 8), *rest)        # 16 bytes in: aligned
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpa._check_cuda_inputs(_offset_view(q, 1), *rest)
    q32, *rest32 = _inputs(torch.float32, kind, 128, 16)
    tpa._check_cuda_inputs(_offset_view(q32, 4), *rest32)    # 16 bytes in: aligned
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpa._check_cuda_inputs(_offset_view(q32, 1), *rest32)


def test_programs_per_row():
    # rows = T * H/KH; kv heads 8: one CTA of up to 4 row groups of 16 rows
    for rows, mma in ((2, 8), (4, 8), (16, 8), (32, 8), (48, 8), (65, 16), (512, 64)):
        for route in tpa.ROUTE_KERNELS:
            assert tpa.programs_per_row(route, rows, 8) == mma, (route, rows)
    assert [tpa.mma_row_groups(r) for r in (1, 16, 17, 32, 33, 512)] == [1, 1, 2, 2, 4, 4]
    with pytest.raises(KeyError):
        tpa.programs_per_row("scalar_float", 16, 8)   # the retired scalar kernel


# (b, t, h, kh, d, nblk): the card's split counts at the serving shapes, on
# a stubbed 132-SM card
SERVING = {
    # llama-3-8b-lite decode, 32 rows: 8 programs a row fill 256 >= 132 SMs
    "decode llama-3-8b-lite": ((32, 1, 32, 8, 128, 13), 1),
    # bench long context: 16 rows x 8 programs = 128 < 132 -> 2 splits
    "long context": ((16, 1, 32, 8, 128, 512), 2),
    # prefill chunk of 128 tokens: 64 mma programs a row, no split
    "prefill": ((32, 128, 32, 8, 128, 13), 1),
    # tiny-real-llama decode, 4 rows x 2 programs: split to nblk / 4
    "decode tiny-real-llama": ((4, 1, 4, 2, 16, 16), 4),
}


@pytest.fixture
def card_splits(monkeypatch):
    """num_splits_for on a stand-in for a card tensor of q's shape and
    dtype, with the card's SM count stubbed to 132."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=132))

    def splits(q, kh, nblk, num_splits, kind):
        on_card = SimpleNamespace(shape=q.shape, dtype=q.dtype, is_cuda=True, device="cuda")
        return tpa.num_splits_for(on_card, kh, nblk, num_splits, kind)
    return splits


@pytest.mark.parametrize("name", list(SERVING))
@pytest.mark.parametrize("kind", KINDS)
def test_num_splits_for_at_the_serving_shapes(name, kind, card_splits):
    (b, t, h, kh, d, nblk), want = SERVING[name]
    q = torch.zeros((b, t, h, d), dtype=torch.bfloat16)
    got = card_splits(q, kh, nblk, 0, kind)
    assert got == want
    programs = tpa.programs_per_row(tpa.ROUTES[(q.dtype, kind)], t * h // kh, kh)
    assert got == tpa.resolve_num_splits(0, nblk=nblk, batch=b, q_chunks=programs,
                                         q_tokens=t, state_rows=t * h // kh, kv_heads=kh,
                                         head_dim=d, core_count=132)
    # on a CPU tensor it stays the JAX kernel's choice
    assert tpa.num_splits_for(q, kh, nblk, 0, kind) == tpa.resolve_num_splits(
        0, nblk=nblk, batch=b, q_chunks=1, q_tokens=t, state_rows=t * h // kh,
        kv_heads=kh, head_dim=d)


def test_num_splits_for_counts_the_route_programs(card_splits):
    """8 query tokens x rep 4 = 32 rows: every route (f32 q over the f32
    cache included, whose scalar kernel had 2 row tiles of 16 a kv head and
    split 9 ways) runs one CTA of 2 row groups a kv head, so it splits
    further to fill the card."""
    q32 = torch.zeros((1, 8, 32, 128), dtype=torch.float32)
    q16 = q32.to(torch.bfloat16)
    assert card_splits(q32, 8, 64, 0, "float") == 16
    assert card_splits(q32, 8, 64, 0, "int8") == 16
    assert card_splits(q16, 8, 64, 0, "int8") == 16
    assert card_splits(q16, 8, 64, 3, "int8") == 3


def test_int_values_widen_to_bf16_exactly():
    i8 = torch.arange(-127, 128, dtype=torch.int32)
    i4 = torch.arange(-8, 8, dtype=torch.int32)
    for vals in (i8, i4):
        assert torch.equal(vals.to(torch.bfloat16).to(torch.int32), vals)


def _bf16_of_bits(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) as f32 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def test_kernel_widening_bit_tricks_are_exact():
    """The mma kernel's widening: int8 byte b -> f32 bits 0x4B000000 | (b ^
    0x80) minus 2^23 + 128, whose upper half is the bf16; int4 nibble n ->
    bf16 bits 0x4300 | (n ^ 8) minus 136 (the sign-extended x - ((x&8)<<1))."""
    b = np.arange(256, dtype=np.uint32)
    f = ((0x4B000000 | (b ^ 0x80)).view(np.float32) - np.float32(8388736.0)).astype(np.float32)
    assert np.array_equal(f, b.astype(np.uint8).view(np.int8).astype(np.float32))
    assert not (f.view(np.uint32) & 0xFFFF).any()  # the bf16 is the upper half, exactly
    assert np.array_equal(_bf16_of_bits((f.view(np.uint32) >> 16).astype(np.uint16)), f)
    n = np.arange(16, dtype=np.uint32)
    bias = _bf16_of_bits(np.array([0x4308], np.uint16))            # 136
    w = _bf16_of_bits((0x4300 | (n ^ 8)).astype(np.uint16)) - bias
    assert np.array_equal(w, (n.astype(np.int64) - ((n & 8) << 1)).astype(np.float32))
    # both nibbles of one packed byte: element d low, d + D/2 high
    packed = torch.arange(256, dtype=torch.int32).to(torch.uint8)[:, None]
    lo_hi = tpa.unpack_int4(packed)
    assert np.array_equal(lo_hi[:, 0].numpy(), w[np.arange(256) & 15])
    assert np.array_equal(lo_hi[:, 1].numpy(), w[np.arange(256) >> 4])


@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_kernel_q_scale_matches_scale_query(d):
    """The mma kernel scales q as it loads it: the f32 product of the bf16
    q and the bf16-rounded D^-0.5 (exact: 8-bit x 8-bit significands),
    rounded once to bf16, is the wrapper's ``scale_query`` bit for bit."""
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32) * 8).to(torch.bfloat16)
    s = tpa._query_scale(d, torch.bfloat16)
    assert torch.tensor(s, dtype=torch.bfloat16).item() == s
    exact = q.double() * s
    assert torch.equal(exact.float().double(), exact)
    kernel = (q.float() * torch.tensor(s, dtype=torch.float32)).to(torch.bfloat16)
    assert torch.equal(kernel.view(torch.int16), tpa.scale_query(q).view(torch.int16))


@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_query_f32_q_scale_matches_scale_query(d):
    """The kernel's f32-q policy (``QueryF32``) scales f32 q as it loads
    it: one f32 multiply by D^-0.5 rounded to f32, i.e. the exact
    product (24-bit x 24-bit significands fit a double) rounded once to
    f32, is the wrapper's ``scale_query`` bit for bit."""
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32) * 8)
    s = tpa._query_scale(d, torch.float32)
    assert torch.tensor(s, dtype=torch.float32).item() == s
    kernel = (q.double() * s).float()
    assert torch.equal(kernel.view(torch.int32), tpa.scale_query(q).view(torch.int32))


@pytest.mark.parametrize("v_kind", ["int8", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_p_keeps_pv_to_2_pow_minus_16(seed, v_kind):
    """A unit of 16 positions: p in [0, 1] (softmax weights) times int8 V
    or bf16 V (standard-normal values rounded to bf16), summed in f32 as
    the MMA does. p as one bf16 errs by up to 2^-9 a weight; p_hi + p_lo
    within 2^-16 of sum |p v|."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((64, 16)).astype(np.float32) * 4
    p = torch.from_numpy(np.exp(s - s.max(axis=1, keepdims=True)))
    if v_kind == "int8":
        v = torch.from_numpy(rng.integers(-127, 128, size=(16, 128)).astype(np.float32))
    else:
        v = torch.from_numpy(rng.standard_normal((16, 128)).astype(np.float32))
        v = v.to(torch.bfloat16).float()
    ref = p.double() @ v.double()
    scale = p.double().abs() @ v.double().abs()
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    split = (hi @ v + lo @ v).double()
    assert ((split - ref).abs() / scale).max().item() <= 2.0**-16
    one = (hi @ v).double()
    assert ((one - ref).abs() / scale).max().item() > 2.0**-12  # why the split is needed


# ---------------------------------------------------------------------------
# f32 q on the tensor cores: the exact three-term bf16 split of q and p
# ---------------------------------------------------------------------------

#: chip_smoke.py's limit for the f32-q routes: |err| <= F32_REL |ref| + F32_ABS
F32_REL = F32_ABS = 2e-5


def _bf16_rn(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (returned as f32) with round to nearest even, as
    ``__float2bfloat16_rn`` rounds (finite inputs)."""
    b = np.asarray(x, np.float32).view(np.uint32)
    r = ((b >> 16) & 1) + np.uint32(0x7FFF)
    return ((b + r) & np.uint32(0xFFFF0000)).view(np.float32)


def _split(x: np.ndarray, terms: int) -> list[np.ndarray]:
    """The kernel's split_bf16: term i is what the earlier terms leave,
    rounded to bf16; every remainder is taken in f32."""
    out, rest = [], np.asarray(x, np.float32)
    for _ in range(terms):
        t = _bf16_rn(rest)
        out.append(t)
        rest = (rest - t).astype(np.float32)
    return out


def _normal_f32(rng, n: int, e_lo: int, e_hi: int) -> np.ndarray:
    """Normal f32 numbers with random 24-bit significands, signs and
    exponents in [e_lo, e_hi]."""
    sig = (rng.integers(0, 2**23, size=n) | 2**23).astype(np.float64) / 2**23
    e = rng.integers(e_lo, e_hi + 1, size=n).astype(np.float64)
    sign = rng.choice([-1.0, 1.0], size=n)
    return (sign * sig * 2.0**e).astype(np.float32)


@pytest.mark.parametrize("e_lo,e_hi", [(-100, -60), (-60, -2), (-2, 2), (2, 60), (60, 100)])
def test_three_way_split_is_exact(e_lo, e_hi):
    rng = np.random.default_rng(e_lo + 1000)
    x = _normal_f32(rng, 50_000, e_lo, e_hi)
    # the emulated rounding is torch's (round to nearest even)
    assert np.array_equal(_bf16_rn(x), torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    hi, mid, lo = _split(x, 3)
    # each remainder is exact in f32, and the third fits bf16 unrounded
    r1 = x.astype(np.float64) - hi
    assert np.array_equal(r1, (x - hi).astype(np.float64))
    assert np.array_equal(r1 - mid, (r1 - mid).astype(np.float32).astype(np.float64))
    assert np.array_equal(lo.astype(np.float64), r1 - mid)
    total = hi.astype(np.float64) + mid + lo
    assert np.array_equal(total, x.astype(np.float64))
    # two terms keep ~16 of the 24 bits
    assert np.mean(hi.astype(np.float64) + mid != x) > 0.9


def _ints(rng, kind: str, shape) -> np.ndarray:
    lo, hi = (-127, 128) if kind == "int8" else (-8, 8)
    return rng.integers(lo, hi, size=shape).astype(np.float64)


@pytest.mark.parametrize("product", ["qk", "pv"])
@pytest.mark.parametrize("kind", QUANT)
def test_three_term_partial_products_are_exact(kind, product):
    """Element by element, in f64: each term times an int8 or int4 value is
    exact in f32 (8-bit x 8-bit significands), and the three partial
    products sum to the exact product. The two-term split of
    test_split_p_keeps_pv_to_2_pow_minus_16 does not."""
    rng = np.random.default_rng(7 if kind == "int8" else 8)
    n = 100_000
    if product == "qk":   # q * D^-0.5 in f32, as the kernel loads it
        x = (rng.standard_normal(n).astype(np.float32) * 4
             * np.float32(tpa._query_scale(128, torch.float32))).astype(np.float32)
    else:                 # softmax weights in [0, 1]
        x = np.exp(-rng.exponential(4.0, n)).astype(np.float32)
    w = _ints(rng, kind, n)
    w[w == 0] = 1
    exact = x.astype(np.float64) * w
    parts = [t.astype(np.float64) * w for t in _split(x, 3)]
    for p in parts:
        assert np.array_equal(p.astype(np.float32).astype(np.float64), p)
    assert np.array_equal(parts[0] + parts[1] + parts[2], exact)
    two = [t.astype(np.float64) * w for t in _split(x, 2)]
    assert np.mean(two[0] + two[1] != exact) > 0.9


def _k_steps(kind: str, d: int) -> list[np.ndarray]:
    """The head-dim elements of each k-step of q.k in the kernel's
    fragment layout: k-step kk holds q_elem(kk, tig, j) and the next, for
    tig < 4, j < 2 (csrc/paged_attention_mma.cu, QuantCache::q_elem)."""
    kch = d // 8 if kind == "int4" else d // 4
    steps = []
    for kk in range(d // 16):
        idx = []
        for tig in range(4):
            for j in range(2):
                e0 = ((d // 2 if j else 0) + tig * kch + 2 * kk if kind == "int4"
                      else tig * kch + 4 * kk + 2 * j)
                idx += [e0, e0 + 1]
        steps.append(np.array(idx))
    assert np.array_equal(np.sort(np.concatenate(steps)), np.arange(d))
    return steps


def _mma(c: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """c + a.b^T over one k-step: exact products summed, one f32 rounding."""
    return (c.astype(np.float64) + a.astype(np.float64) @ b.T).astype(np.float32)


def _within_f32_limit(got, ref) -> float:
    return float(np.max(np.abs(got - ref) / (F32_REL * np.abs(ref) + F32_ABS)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", QUANT)
def test_f32_summed_split_emulation_within_the_f32_limit(kind, seed):
    """The f32-q kernel at the decode shape (D=128, rep 4 query rows of a kv
    head, 10 units of 16 positions, one block a unit), emulated: q * D^-0.5
    in f32 split into three bf16 terms, q.k as three MMAs a k-step of the
    kernel's layout, each summing exact products into the f32 accumulator
    with one rounding; the K scale on the scores; the online softmax in
    f32; p split into three terms, p.v as three MMAs a unit; the V scale;
    the final division. Scores, each unit's p.v and the output stay within
    the f32 limit of the f64 reference."""
    rng = np.random.default_rng(seed)
    d, rows, units, unit = 128, 4, 10, 16
    qmax = 127.0 if kind == "int8" else tpa.INT4_QMAX
    q = (rng.standard_normal((rows, d)).astype(np.float32)
         * np.float32(tpa._query_scale(d, torch.float32))).astype(np.float32)
    kv = {}
    for name in ("k", "v"):
        real = rng.standard_normal((units, unit, d))
        scale = (np.abs(real).max(axis=(1, 2)) / qmax).astype(np.float32)   # a block's
        ints = np.clip(np.round(real / scale[:, None, None]), -qmax, qmax)
        kv[name] = (ints, scale)
    (k, ks), (v, vs) = kv["k"], kv["v"]
    steps = _k_steps(kind, d)
    q_terms = _split(q, 3)

    m = np.full(rows, -1e30, np.float32)
    l = np.zeros(rows, np.float32)
    acc = np.zeros((rows, d), np.float32)
    ref_s = []
    for u in range(units):
        s = np.zeros((rows, unit), np.float32)
        for idx in steps:
            for t in q_terms:
                s = _mma(s, t[:, idx], k[u][:, idx])
        s = (s * ks[u]).astype(np.float32)
        ref = q.astype(np.float64) @ k[u].T * np.float64(ks[u])
        assert _within_f32_limit(s, ref) <= 1.0
        ref_s.append(ref)
        m_new = np.maximum(m, s.max(axis=1))
        alpha = np.exp(m - m_new).astype(np.float32)
        p = np.exp(s - m_new[:, None]).astype(np.float32)
        l = (l * alpha + p.sum(axis=1, dtype=np.float32)).astype(np.float32)
        pv = np.zeros((rows, d), np.float32)
        for t in _split(p, 3):
            pv = _mma(pv, t, v[u].T)
        pv = (pv * vs[u]).astype(np.float32)
        pv_ref = p.astype(np.float64) @ v[u] * np.float64(vs[u])
        assert _within_f32_limit(pv, pv_ref) <= 1.0
        acc = (acc.astype(np.float64) * alpha[:, None] + pv).astype(np.float32)  # fmaf
        m = m_new
    out = (acc / l[:, None]).astype(np.float32)
    s_all = np.concatenate(ref_s, axis=1)                                   # [rows, S]
    w = np.exp(s_all - s_all.max(axis=1, keepdims=True))
    v_all = (v * vs[:, None, None].astype(np.float64)).reshape(units * unit, d)
    ref_out = (w @ v_all) / w.sum(axis=1, keepdims=True)
    assert _within_f32_limit(out, ref_out) <= 1.0


# ---------------------------------------------------------------------------
# f32 q over the f32 cache: K and V split three ways too, six MMAs a product
# ---------------------------------------------------------------------------

def _f32_k_chunk(d: int, kk: int, tig: int) -> int:
    """F32Cache::k_chunk: the 16-byte chunk of a K row thread tig reads
    for k-step kk."""
    nk = d // 16
    return 8 * (kk >> 1) + 2 * tig + (kk & 1) if kk < (nk & ~1) else 4 * kk + tig


def _f32_dmap(d: int, j: int, n: int) -> int:
    """F32Cache::dmap: the head-dim element of column n of p.v's n-tile j."""
    ng = d // 32
    return 32 * (j >> 2) + 4 * n + (j & 3) if j < 4 * ng else 32 * ng + 2 * n + (j - 4 * ng)


@pytest.mark.parametrize("d", [16, 48, 128, 256])
def test_f32_cache_fragment_layout(d):
    """One unit through the m16n8k16 fragments as the f32-cache kernel
    fills them: lane (gid, tig) holds q elements q_elem(kk, tig, j) in its A
    words and the K floats of chunk k_chunk(kk, tig) of positions gid, gid+8
    in its B words; for p.v the V floats it reads at byte 16 (8g + gid) of
    positions 2tig, 2tig+1, 2tig+8, 2tig+9 (8 bytes at 4 (32 NG + 2 gid) for
    a last pair of n-tiles), whose columns dmap names. S = Q.K^T and O = P.V
    come out exact (small integers), and every 16-byte read phase of 8 lanes
    hits 8 distinct bank groups where D is a multiple of 32 (row stride
    4D + 16 bytes)."""
    rng = np.random.default_rng(d)
    nk, nn, ng = d // 16, d // 8, d // 32
    q = rng.integers(-4, 5, size=(16, d)).astype(np.float64)
    k = rng.integers(-4, 5, size=(16, d)).astype(np.float64)
    v = rng.integers(-4, 5, size=(16, d)).astype(np.float64)
    p = rng.integers(-4, 5, size=(16, 16)).astype(np.float64)
    sp = 4 * d + 16
    s = np.zeros((16, 16))
    for kk in range(nk):
        a = np.zeros((16, 16))               # rows x contraction slots
        b = np.zeros((2, 16, 8))             # n-tile, slots x columns
        for lane in range(32):
            gid, tig = lane >> 2, lane & 3
            c = _f32_k_chunk(d, kk, tig)
            for j in range(2):
                e = 4 * c + 2 * j            # QueryF32 reads q elements e, e + 1
                for i in range(2):
                    a[gid, 2 * tig + 8 * j + i] = q[gid, e + i]
                    a[gid + 8, 2 * tig + 8 * j + i] = q[gid + 8, e + i]
            for n in range(2):
                f4 = k[gid + 8 * n, 4 * c: 4 * c + 4]   # the float4 at byte 16 c
                b[n, [2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9], gid] = f4
        for n in range(2):
            s[:, 8 * n: 8 * n + 8] += a @ b[n]
        if d % 32 == 0:                      # a read phase: lanes 0-7 (gid 0, 1)
            groups = {(gid * sp // 16 + _f32_k_chunk(d, kk, tig)) % 8
                      for gid in (0, 1) for tig in range(4)}
            assert len(groups) == 8, (kk, groups)
    assert np.array_equal(s, q @ k.T)
    o = np.zeros((16, d))
    cols = []
    for j in range(nn):
        b = np.zeros((16, 8))
        for lane in range(32):
            gid, tig = lane >> 2, lane & 3
            byte = 16 * (8 * (j >> 2) + gid) + 4 * (j & 3) if j < 4 * ng else \
                4 * (32 * ng + 2 * gid) + 4 * (j - 4 * ng)
            assert byte // 4 == _f32_dmap(d, j, gid)
            for i4 in range(4):
                pos = 2 * tig + (i4 & 1) + 8 * (i4 >> 1)
                b[pos, gid] = v[pos, byte // 4]
        out = p @ b
        for n in range(8):
            o[:, _f32_dmap(d, j, n)] = out[:, n]
            cols.append(_f32_dmap(d, j, n))
    assert sorted(cols) == list(range(d))
    assert np.array_equal(o, p @ v)
    if d % 32 == 0:                          # V read phase: lanes 0-7, one i4
        for g in range(ng):
            for i4 in range(4):
                groups = {((2 * tig + (i4 & 1) + 8 * (i4 >> 1)) * sp // 16 + 8 * g + gid) % 8
                          for gid in (0, 1) for tig in range(4)}
                assert len(groups) == 8, (g, i4, groups)


@pytest.mark.parametrize("product", ["qk", "pv"])
def test_dropped_term_products_are_below_2_pow_minus_24(product):
    """f32 q (or p) times an f32 cache element, both split three ways: the
    three term products the kernel drops (mid.lo, lo.mid, lo.lo) are each
    at most 2^-24 of |x||w| (|mid| <= 2^-8 |x|, |lo| <= 2^-16 |x|), the six
    it keeps sum to the exact product within their sum, 2^-23 + 2^-32 of
    |x||w|, and the smallest kept ones (hi.lo, lo.hi, mid.mid) are larger
    than that: none of them could go."""
    rng = np.random.default_rng(11 if product == "qk" else 12)
    n = 200_000
    if product == "qk":
        x = (rng.standard_normal(n).astype(np.float32)
             * np.float32(tpa._query_scale(128, torch.float32))).astype(np.float32)
    else:
        x = np.exp(-rng.exponential(4.0, n)).astype(np.float32)
    w = rng.standard_normal(n).astype(np.float32) * 3
    xt = [t.astype(np.float64) for t in _split(x, 3)]
    wt = [t.astype(np.float64) for t in _split(w, 3)]
    mag = np.abs(x.astype(np.float64) * w)
    dropped = {name: np.abs(xt[i] * wt[j]) / mag
               for name, (i, j) in {"mid.lo": (1, 2), "lo.mid": (2, 1), "lo.lo": (2, 2)}.items()}
    for name, rel in dropped.items():
        assert rel.max() <= 2.0**-24, (name, rel.max())
    kept = sum(xt[i] * wt[j] for i, j in ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1)))
    miss = np.abs(kept - x.astype(np.float64) * w) / mag
    assert miss.max() <= 2.0**-23 + 2.0**-32
    assert miss.max() > 2.0**-30                  # the drop is seen, and measured
    for i, j in ((0, 2), (2, 0), (1, 1)):
        assert (np.abs(xt[i] * wt[j]) / mag).max() > 2.0**-23


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", ["decode D=128", "decode D=16"])
def test_f32_cache_split_emulation_within_the_f32_limit(shape, seed):
    """The f32-cache kernel (f32 q over an f32 cache) emulated at the
    decode shapes of llama-3-8b-lite (D=128, 4 query rows a kv head) and
    tiny-real-llama (D=16, 2 rows), 10 units of 16 positions: q * D^-0.5
    in f32 and every K and V element split into three bf16 terms; q.k a
    k-step of the kernel's layout at a time as six MMAs in the kernel's
    order, the three with q_hi into one accumulator and the three with
    q_mid / q_lo into a second, each MMA summing exact products with one
    f32 rounding, the two added at the end; the online softmax in f32; p
    split into three terms and p.v as the six MMAs of mma6 a unit,
    smallest products first. Scores, each unit's p.v and the output stay
    within the f32 limit of the f64 reference."""
    rng = np.random.default_rng(seed)
    d, rows = (128, 4) if shape == "decode D=128" else (16, 2)
    units, unit = 10, 16
    q = (rng.standard_normal((rows, d)).astype(np.float32)
         * np.float32(tpa._query_scale(d, torch.float32))).astype(np.float32)
    k = rng.standard_normal((units, unit, d)).astype(np.float32)
    v = rng.standard_normal((units, unit, d)).astype(np.float32)
    steps = [np.array([4 * _f32_k_chunk(d, kk, tig) + i for tig in range(4) for i in range(4)])
             for kk in range(d // 16)]
    assert np.array_equal(np.sort(np.concatenate(steps)), np.arange(d))
    qh, qm, ql = _split(q, 3)
    pairs = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))   # mma6's order

    m = np.full(rows, -1e30, np.float32)
    l = np.zeros(rows, np.float32)
    acc = np.zeros((rows, d), np.float32)
    ref_s = []
    for u in range(units):
        kh, km, kl = _split(k[u], 3)
        s = np.zeros((rows, unit), np.float32)
        s2 = np.zeros((rows, unit), np.float32)
        for idx in steps:
            for qt, kt in ((qm, km), (ql, kh), (qm, kh)):
                s2 = _mma(s2, qt[:, idx], kt[:, idx])
            for kt in (kl, km, kh):
                s = _mma(s, qh[:, idx], kt[:, idx])
        s = (s + s2).astype(np.float32)
        ref = q.astype(np.float64) @ k[u].T.astype(np.float64)
        assert _within_f32_limit(s, ref) <= 1.0
        ref_s.append(ref)
        m_new = np.maximum(m, s.max(axis=1))
        alpha = np.exp(m - m_new).astype(np.float32)
        p = np.exp(s - m_new[:, None]).astype(np.float32)
        l = (l * alpha + p.sum(axis=1, dtype=np.float32)).astype(np.float32)
        pt, vt = _split(p, 3), _split(v[u].T, 3)             # vt: [d, unit] terms
        pv = np.zeros((rows, d), np.float32)
        for i, j in pairs:
            pv = _mma(pv, pt[i], vt[j])
        pv_ref = p.astype(np.float64) @ v[u].astype(np.float64)
        assert _within_f32_limit(pv, pv_ref) <= 1.0
        acc = (acc.astype(np.float64) * alpha[:, None] + pv).astype(np.float32)  # fmaf
        m = m_new
    out = (acc / l[:, None]).astype(np.float32)
    s_all = np.concatenate(ref_s, axis=1)
    w = np.exp(s_all - s_all.max(axis=1, keepdims=True))
    ref_out = (w @ v.reshape(units * unit, d).astype(np.float64)) / w.sum(axis=1, keepdims=True)
    assert _within_f32_limit(out, ref_out) <= 1.0
