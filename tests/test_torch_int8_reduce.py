"""The three local kernels of the port's int8 all-reduce, on CPU tensors
(their plain versions), composed over a simulated exchange (every rank's
tensors stacked, no process group), against the reference's
``quantized_psum`` algebra (``repro/core/quantized_collectives.py``), on the
same numpy-seeded inputs.

Each of the reference's steps is compiled on its own with ``jax.jit``, as
on the TPU: XLA then multiplies by the fp32 reciprocal of 127 where the
source divides, which is what the port's quantize computes (run eagerly,
the division differs in the last bit of some scales).  Compiled as one
program, XLA also fuses each dequantize product into the rank sum as an
FMA, a rounding that neither the reference's source nor the port spells
out; that whole program is held to the tolerance below.  At tp = 2 the
quantized shards, the re-quantized slice and its scale, and the reduced
tensor must be EQUAL to the reference's steps; at tp = 4 the shards must be
equal and the result within one step of the output scale (amax/127 of the
reduced slice, ``tests/test_torch_tp.py``'s tolerance for the quantized
reduce): the fp32 sum of four dequantized shards may round in another order
and re-quantize one step apart.  The whole compiled ``quantized_psum`` is
held to that tolerance at both.  On the card ``chip_smoke.py`` (phase 2)
holds each kernel bit-equal to these plain versions."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import quantized_collectives as r_qc  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import int8_quant as q8  # noqa: E402

torch.set_num_threads(1)
# (shape per rank, seed): decode- and prefill-like rows, a 3-D partial, and
# shards of 18 (off the kernel's 8-value vectors)
SHAPES = [((4, 64), 0), ((2, 3, 32), 1), ((7, 72), 2)]


def _inputs(tp, shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal((tp, *shape)) * 3
    x = x.astype(np.float32)
    if dtype == "bfloat16":
        import ml_dtypes
        x = x.astype(ml_dtypes.bfloat16)
    return x


def _reference(x, tp):
    """The reference's steps, each compiled, over the stacked ranks: the
    shards (q, s) (rank, shard, ...), the re-quantized slices (q2, s2)
    (rank, ...), the reduced tensor, and every rank's result of the whole
    ``quantized_psum`` compiled as one program."""
    quant = jax.jit(r_qc.quantize_int8)
    deq = jax.jit(r_qc.dequantize_int8)
    rank_sum = jax.jit(lambda a: jnp.sum(a, axis=0))
    xs = jnp.asarray(x).reshape(*x.shape[:-1], tp, x.shape[-1] // tp)
    q, s = quant(xs)                          # (rank, ..., shard, d)
    q, s = jnp.moveaxis(q, -2, 1), jnp.moveaxis(s, -2, 1)
    # the exchange: rank r receives shard r of every rank, in rank order
    q2, s2 = zip(*[quant(rank_sum(deq(q[:, r], s[:, r])))
                   for r in range(tp)])
    q2, s2 = jnp.stack(q2), jnp.stack(s2)     # the gather
    blocks = jnp.moveaxis(q2, 0, -2)          # (..., tp, d)
    s2_g = jnp.moveaxis(s2, 0, -2)[..., 0]    # (..., tp)
    out = jax.jit(lambda b, sg: (b.astype(jnp.float32) * sg[..., None])
                  .reshape(*b.shape[:-2], -1).astype(x.dtype))(blocks, s2_g)
    whole = jax.jit(jax.vmap(lambda a: r_qc.quantized_psum(a, "model", tp),
                             axis_name="model"))(jnp.asarray(x))
    return [np.asarray(t) for t in (q, s, q2, s2, out, whole)]


def _port(x, tp):
    """The port's three functions over the same simulated exchange."""
    xt = bridge.to_torch(x)
    shards = [q8.quantize_int8_shards(xt[r], tp) for r in range(tp)]
    q = torch.stack([a for a, _ in shards])          # (rank, shard, ...)
    s = torch.stack([b for _, b in shards])
    slices = [q8.dequant_sum_quantize_int8(q[:, r], s[:, r])
              for r in range(tp)]
    q2 = torch.stack([a for a, _ in slices])         # (rank, ...)
    s2 = torch.stack([b for _, b in slices])
    out = q8.dequantize_int8_gathered(q2, s2, xt.dtype)
    return q, s, q2, s2, out


def _step(want, tp):
    """One step of the output scale at every element of the result."""
    w = np.abs(want.astype(np.float32))
    blocks = w.reshape(*w.shape[:-1], tp, -1)
    return np.broadcast_to(blocks.max(axis=-1, keepdims=True) / 127.0,
                           blocks.shape).reshape(w.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,seed", SHAPES)
@pytest.mark.parametrize("tp", [2, 4])
def test_int8_reduce_steps_match_reference(tp, shape, seed, dtype):
    x = _inputs(tp, shape, seed, dtype)
    rq, rs, rq2, rs2, rout, whole = _reference(x, tp)
    q, s, q2, s2, out = _port(x, tp)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (tp, tp, *shape[:-1], shape[-1] // tp)
    assert s.shape == (tp, tp, *shape[:-1], 1)
    np.testing.assert_array_equal(q.numpy(), rq)
    np.testing.assert_array_equal(s.numpy(), rs)
    # every rank ends with the same reduced tensor, in x's dtype
    assert out.shape == shape and out.dtype == bridge.to_torch(x).dtype
    got = out.float().numpy()
    want = np.asarray(rout, np.float32)
    if tp == 2:
        np.testing.assert_array_equal(q2.numpy(), rq2)
        np.testing.assert_array_equal(s2.numpy(), rs2)
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= _step(want, tp) * 1.001 + 1e-7)
    for r in range(tp):
        w = np.asarray(whole[r], np.float32)
        assert np.all(np.abs(got - w) <= _step(w, tp) * 1.001 + 1e-7)
    # the sum really is a reduce: far from any single rank's input
    assert np.abs(want - np.asarray(x[0], np.float32)).max() > 1.0


def test_rank_sum_runs_in_rank_order():
    """The plain sum is the explicit loop the kernel repeats bit for bit:
    ((q0 s0 + q1 s1) + q2 s2) + q3 s3, each product and sum rounded to fp32."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.integers(-127, 128, (4, 3, 40)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(1e-3, 2, (4, 3, 1)).astype(np.float32))
    want = ((q[0].float() * s[0] + q[1].float() * s[1])
            + q[2].float() * s[2]) + q[3].float() * s[3]
    got_q, got_s = q8.dequant_sum_quantize_int8(q, s)
    assert got_q.shape == (3, 40) and got_s.shape == (3, 1)
    for a, b in zip((got_q, got_s), q8.quantize_int8_plain(want)):
        assert torch.equal(a, b)


def test_int8_reduce_wrappers_reject_bad_inputs():
    q = torch.zeros(2, 3, 8, dtype=torch.int8)
    s = torch.ones(2, 3, 1)
    with pytest.raises(ValueError):                  # D not a multiple of tp
        q8.quantize_int8_shards(torch.zeros(3, 10), 4)
    with pytest.raises(TypeError):                   # integer input
        q8.quantize_int8_shards(torch.zeros(3, 8, dtype=torch.int32), 2)
    with pytest.raises(TypeError):                   # scales not fp32
        q8.dequant_sum_quantize_int8(q, s.double())
    with pytest.raises(ValueError):                  # scales of other rows
        q8.dequant_sum_quantize_int8(q, torch.ones(2, 4, 1))
    with pytest.raises(TypeError):                   # q not int8
        q8.dequantize_int8_gathered(q.float(), s, torch.float32)
    with pytest.raises(TypeError):                   # output dtype
        q8.dequantize_int8_gathered(q, s, torch.float16)
    assert q8.dequantize_int8_gathered(q, s, torch.bfloat16).shape == (3, 16)
