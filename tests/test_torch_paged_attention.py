"""The paged-attention kernel's plain PyTorch version (the CPU side of
``dynamo_tpu_torch.ops.paged_attention``) against the JAX package's Pallas
kernel run in interpret mode, at the geometries of tests/test_ops.py.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version there.

Tolerances: 2e-5 in f32 (the kernel's online softmax and the plain
version's one-pass softmax associate sums differently — f32 rounding
only); 2e-2 in bf16 (one bf16 rounding of an O(1) output, as
tests/test_ops.py holds the TPU kernel at the bench shapes).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu_torch.ops import paged_attention as tpa

F32 = dict(atol=2e-5, rtol=2e-5)


def _case(rng, b, t, h, kh, d, nb, bs, nblk):
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((nb, bs, kh, d)).astype(np.float32)
    v = rng.standard_normal((nb, bs, kh, d)).astype(np.float32)
    bt = (rng.permutation(nb - 1)[: b * nblk].reshape(b, nblk) + 1).astype(np.int32)
    q_start = rng.integers(0, nblk * bs - t, size=(b,)).astype(np.int32)
    return q, k, v, bt, q_start, (q_start + t).astype(np.int32)


def _both(case, num_splits=1, dtype="float32"):
    q, k, v, bt, qs, kl = case
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    ref = jpa.paged_attention_kernel(
        *(jnp.asarray(a, jd) for a in (q, k, v)), *(jnp.asarray(a) for a in (bt, qs, kl)),
        num_splits=num_splits, interpret=True)
    out = tpa.paged_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)),
        *(torch.from_numpy(a) for a in (bt, qs, kl)), num_splits=num_splits)
    return out.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("kh,h", [(2, 2), (2, 8)])
def test_plain_matches_pallas_kernel(t, kh, h):
    rng = np.random.default_rng(0)
    out, ref = _both(_case(rng, b=3, t=t, h=h, kh=kh, d=64, nb=32, bs=16, nblk=4))
    np.testing.assert_allclose(out, ref, **F32)


def test_plain_matches_pallas_ragged_lengths():
    rng = np.random.default_rng(1)
    q, k, v, bt, _, _ = _case(rng, 4, 4, 4, 2, 64, 32, 16, 4)
    qs = np.array([0, 5, 17, 40], np.int32)
    out, ref = _both((q, k, v, bt, qs, qs + 4))
    np.testing.assert_allclose(out, ref, **F32)


def test_plain_zero_len_row_outputs_zero():
    rng = np.random.default_rng(2)
    q, k, v, bt, _, _ = _case(rng, 2, 1, 2, 2, 64, 16, 16, 2)
    qs = np.zeros(2, np.int32)
    out, ref = _both((q, k, v, bt, qs, np.array([1, 0], np.int32)))
    np.testing.assert_allclose(out, ref, **F32)
    assert np.isfinite(out).all() and (out[1] == 0).all()


def test_plain_matches_pallas_qchunked(monkeypatch):
    """The Pallas kernel split into several q-row chunks (its long-prefill
    path) still equals the plain version."""
    monkeypatch.setattr(jpa, "_SCRATCH_CAP_BYTES", 64 * 1024)
    rng = np.random.default_rng(4)
    out, ref = _both(_case(rng, 2, 16, 8, 2, 128, 32, 16, 4))
    np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("ns", [2, 4])
def test_plain_split_k_matches_pallas(ns):
    rng = np.random.default_rng(12)
    case = _case(rng, 3, 1, 4, 2, 64, 32, 16, 8)
    out, ref = _both(case, num_splits=ns)
    np.testing.assert_allclose(out, ref, **F32)
    seq, _ = _both(case, num_splits=1)
    np.testing.assert_allclose(out, seq, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("ns", [2, 4])
def test_plain_split_k_wildly_ragged_and_prefill(ns):
    """Splits that hold no context for a row (m = -inf, l = 0) carry zero
    weight; T > 1 chunks split the same way."""
    rng = np.random.default_rng(13)
    q, k, v, bt, _, _ = _case(rng, 4, 1, 4, 2, 64, 48, 16, 8)
    kl = np.array([1, 16, 63, 128], np.int32)
    out, ref = _both((q, k, v, bt, kl - 1, kl), num_splits=ns)
    np.testing.assert_allclose(out, ref, **F32)
    rng = np.random.default_rng(21)
    q, k, v, bt, _, _ = _case(rng, 1, 8, 8, 8, 128, 20, 16, 16)
    qs = np.array([16 * 16 - 8], np.int32)
    out, ref = _both((q, k, v, bt, qs, qs + 8), num_splits=ns)
    np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("ns", [1, 4])
def test_plain_bf16_at_bench_shapes(ns):
    """bf16 at the llama-3-8b-lite attention geometry (kh=8, d=128, bs=16),
    including the kernel's q scaling in bf16."""
    rng = np.random.default_rng(7)
    out, ref = _both(_case(rng, 2, 1, 8, 8, 128, 24, 16, 4), num_splits=ns,
                     dtype="bfloat16")
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=2e-2)


def test_plain_bf16_prefill_at_bench_shapes():
    """A 128-token prefill chunk at the llama-3-8b-lite attention geometry
    (kh=8, h=32, d=128, bs=16): 512 query rows a kv head, the shape at which
    the card's kernel shares one staged unit between a CTA's row groups."""
    rng = np.random.default_rng(8)
    out, ref = _both(_case(rng, 2, 128, 32, 8, 128, 24, 16, 10), dtype="bfloat16")
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=2e-2)


def test_scale_query_rounds_in_the_query_dtype():
    """q · D^-0.5 with the scale rounded to q's dtype — the TPU kernel's
    convention, bit for bit."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 3, 4, 128)).astype(np.float32)
    ref = np.asarray(jnp.asarray(q, jnp.bfloat16) * (128 ** -0.5), np.float32)
    out = tpa.scale_query(torch.from_numpy(q).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(out, ref)


def _decode_case(rng, kind: str):
    """chip_smoke.py phase (a)'s decode shape (B=32, kv 128-192, KH=8,
    H=32, D=128, BS=16): f32 q, and an f32, int8 or packed-int4 cache."""
    b, h, kh, d, bs, nblk = 32, 32, 8, 128, 16, 16
    nb = b * nblk + 1
    kv_len = rng.integers(128, 193, size=b).astype(np.int32)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32))

    def cache():
        if kind == "float":
            return torch.from_numpy(rng.standard_normal((nb, bs, kh, d)).astype(np.float32))
        qmax = 127 if kind == "int8" else 7
        ints = torch.from_numpy(rng.integers(-qmax, qmax + 1, size=(nb, bs, kh, d)))
        payload = ints.to(torch.int8) if kind == "int8" else tpa.pack_int4(ints)
        # scales of standard-normal rows (amax ~ 3), as chip_smoke quantizes
        scale = rng.uniform(0.7, 1.3, (nb, kh)) * 3 / qmax
        return {"q": payload, "s": torch.from_numpy(scale.astype(np.float32))}

    bt = torch.from_numpy((rng.permutation(nb - 1)[: b * nblk] + 1)
                          .reshape(b, nblk).astype(np.int32))
    kl = torch.from_numpy(kv_len)
    return q, cache(), cache(), bt, kl - 1, kl


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_f32_limit_catches_a_query_rounded_to_bf16(kind):
    """chip_smoke.py holds every f32-q route to |err| <= F32_REL |ref| +
    F32_ABS (2e-5, 2e-5). At its decode shape the plain version with q
    rounded to bf16 breaks that limit against the plain f32 version, while
    the plain f32 version walked in 4 splits (f32 sums in another order)
    keeps it."""
    from chip_smoke import F32_ABS, F32_REL

    q, kc, vc, bt, qs, kl = _decode_case(np.random.default_rng(31), kind)
    ref = tpa.paged_attention_plain(q, kc, vc, bt, qs, kl, num_splits=1)
    limit = F32_REL * ref.abs() + F32_ABS
    split = tpa.paged_attention_plain(q, kc, vc, bt, qs, kl, num_splits=4)
    assert ((split - ref).abs() / limit).max().item() <= 1.0
    q_bf16 = q.to(torch.bfloat16).float()
    rounded = tpa.paged_attention_plain(q_bf16, kc, vc, bt, qs, kl, num_splits=1)
    assert ((rounded - ref).abs() / limit).max().item() > 1.0


@pytest.mark.parametrize("operand", ["k", "v"])
def test_f32_limit_catches_a_cache_rounded_to_bf16(operand):
    """The same limit over the f32 cache: at chip_smoke.py's decode shape
    the plain version over full-precision f32 K and V breaks it when K (or
    V) is rounded to bf16 — what a kernel that read the f32 cache as bf16,
    or dropped its mid and lo terms, would compute. So an f32-cache case
    must hold f32 values that are not bf16 values to test those terms."""
    from chip_smoke import F32_ABS, F32_REL

    q, kc, vc, bt, qs, kl = _decode_case(np.random.default_rng(37), "float")
    assert (kc != kc.to(torch.bfloat16).float()).float().mean().item() > 0.99
    ref = tpa.paged_attention_plain(q, kc, vc, bt, qs, kl, num_splits=1)
    limit = F32_REL * ref.abs() + F32_ABS
    if operand == "k":
        kc = kc.to(torch.bfloat16).float()
    else:
        vc = vc.to(torch.bfloat16).float()
    rounded = tpa.paged_attention_plain(q, kc, vc, bt, qs, kl, num_splits=1)
    assert ((rounded - ref).abs() / limit).max().item() > 1.0


def test_resolve_num_splits_matches_jax():
    table = [
        dict(num_splits=0, nblk=nblk, batch=b, q_chunks=qc, q_tokens=t,
             state_rows=r, kv_heads=kh, head_dim=d)
        for nblk in (1, 4, 5, 16, 128, 512)
        for b in (1, 2, 8, 32)
        for qc in (1, 2)
        for t, r in ((1, 4), (8, 32), (128, 512))
        for kh, d in ((0, 0), (8, 128))
    ]
    table += [dict(num_splits=ns, nblk=nb, batch=1, q_chunks=1, q_tokens=1)
              for ns in (1, 3, 999) for nb in (2, 4, 64)]
    for kw in table:
        assert tpa.resolve_num_splits(**kw) == jpa.resolve_num_splits(**kw), kw
        # The card's SM count only changes the auto gate's core budget.
        assert tpa.resolve_num_splits(**kw, core_count=132) >= 1


def test_wrapper_on_cpu_uses_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(9)
    args = [torch.from_numpy(a) for a in _case(rng, 2, 4, 4, 2, 32, 16, 16, 4)]
    before = dict(tpa.paged_attention.launches_by_kernel)
    out = tpa.paged_attention(*args, num_splits=1)
    assert torch.equal(out, tpa.paged_attention_plain(*args, num_splits=1))
    assert tpa.paged_attention.launches_by_kernel == before
