"""The uint32 key scramble (hash_join_codes_knl_tpu_torch/ops/scramble.py)
on the CPU: its plain version against numpy and the JAX package's
scramble and unscramble bit for bit, the wrapper's CPU dispatch and
refusals, the engine's hot-path callers routed through it with results
equal to the JAX package's, and the other kernels' plain versions kept
off it.  The kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hash_join_codes_knl_tpu.engine.phj as jphj
from hash_join_codes_knl_tpu.engine.config import JoinPlan as JaxPlan
from hash_join_codes_knl_tpu.relgen.generate import generate
from hash_join_codes_knl_tpu.utils import hashing as jh
from hash_join_codes_knl_tpu_torch.engine import phj as tphj
from hash_join_codes_knl_tpu_torch.engine import stream as tstream
from hash_join_codes_knl_tpu_torch.engine.config import (
    DEFAULT_FACTOR,
    JoinPlan,
)
from hash_join_codes_knl_tpu_torch.engine.convert import result_to_numpy
from hash_join_codes_knl_tpu_torch.engine.oracle import (
    join_oracle,
    multiset_digest,
)
from hash_join_codes_knl_tpu_torch.engine.validate import (
    validate_join_result,
)
from hash_join_codes_knl_tpu_torch.ops import chunk_layout as cl
from hash_join_codes_knl_tpu_torch.ops import merge_probe as mp
from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg
from hash_join_codes_knl_tpu_torch.ops import probe as pt
from hash_join_codes_knl_tpu_torch.ops import radix_partition as rp
from hash_join_codes_knl_tpu_torch.ops import scramble as sc
from hash_join_codes_knl_tpu_torch.parallel import cpra as tcpra
from hash_join_codes_knl_tpu_torch.parallel.distributed import (
    run_ranks,
    thread_meshes,
)
from hash_join_codes_knl_tpu_torch.utils import hashing as th
from hash_join_codes_knl_tpu_torch.utils.hashing import (
    BIAS,
    mod_inverse_u32,
    to_numpy_u32,
    u32_to_device,
)

EDGE_KEYS = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
FACTORS = [DEFAULT_FACTOR, mod_inverse_u32(DEFAULT_FACTOR), 0x9E3779B1,
           mod_inverse_u32(0x9E3779B1), 1, 2, 0xFFFFFFFF, 0x80000001]
XORS = [(0, 0), (BIAS, 0), (0, BIAS), (BIAS, BIAS),
        (0x12345678, 0xFFFFFFFF), (-1, 0x80000000)]


def _keys(seed=101, n=4000):
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [EDGE_KEYS, rng.integers(0, 2**32, n, dtype=np.uint32)])


def _np_mul(x, f, a, b):
    u = lambda v: np.uint32(v & 0xFFFFFFFF)
    return ((x ^ u(a)) * u(f)) ^ u(b)


@pytest.mark.parametrize("xor_in,xor_out", XORS)
@pytest.mark.parametrize("factor", FACTORS)
def test_plain_equals_numpy(factor, xor_in, xor_out):
    keys = _keys(seed=factor & 0xFFFF)
    got = sc.mul_u32_torch(u32_to_device(keys, "cpu"), factor, xor_in,
                           xor_out)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy_u32(got),
                                  _np_mul(keys, factor, xor_in, xor_out))


@pytest.mark.parametrize("factor", FACTORS)
def test_plain_equals_jax_hashed_key(factor):
    keys = _keys()
    got = to_numpy_u32(sc.mul_u32(u32_to_device(keys, "cpu"), factor))
    np.testing.assert_array_equal(
        got, np.asarray(jh.hashed_key(jnp.asarray(keys), factor)))
    biased = to_numpy_u32(sc.mul_u32(u32_to_device(keys, "cpu"), factor,
                                     xor_out=BIAS))
    np.testing.assert_array_equal(biased, got ^ np.uint32(0x80000000))


@pytest.mark.parametrize("factor", [DEFAULT_FACTOR, 0x9E3779B1, 1,
                                    0xFFFFFFFF])
def test_unscramble_equals_jax_inline_unscramble(factor):
    """engine/phj.py of the JAX package unscrambles its unbiased probe
    column with `pk * inv`; the port takes the biased column, pads
    (biased null) included, in one pass."""
    keys = _keys()
    keys[::7] = 0  # null pads
    hk = jh.hashed_key(jnp.asarray(keys), factor)
    want = np.asarray(hk * jnp.uint32(jh.mod_inverse_u32(factor)))
    np.testing.assert_array_equal(want, keys)
    pk = th.bias(u32_to_device(np.array(hk), "cpu"))
    got = to_numpy_u32(sc.unscramble(pk, factor))
    np.testing.assert_array_equal(got, want)
    # the int64 chain the engine ran before: unbias, multiply
    np.testing.assert_array_equal(
        got, to_numpy_u32(th.mul_u32(th.unbias(pk),
                                     mod_inverse_u32(factor))))


@pytest.mark.parametrize("xor_in,xor_out", XORS[:4])
def test_cpu_dispatch_takes_the_plain_version(xor_in, xor_out):
    x = u32_to_device(_keys(), "cpu")
    before = sc.mul_u32.launches
    got = sc.mul_u32(x, DEFAULT_FACTOR, xor_in, xor_out)
    assert sc.mul_u32.launches == before
    assert torch.equal(got, sc.mul_u32_torch(x, DEFAULT_FACTOR, xor_in,
                                             xor_out))
    assert sc.mul_u32(x[:0], DEFAULT_FACTOR, xor_in, xor_out).shape == (0,)


@pytest.mark.parametrize("bad", [
    torch.zeros(8, dtype=torch.int64),
    torch.zeros(8, dtype=torch.uint8),
    torch.zeros(8, dtype=torch.float32),
    torch.zeros((2, 4), dtype=torch.int32),
    torch.zeros((), dtype=torch.int32),
    torch.zeros(16, dtype=torch.int32)[::2],
], ids=["int64", "uint8", "float32", "2-D", "0-D", "strided"])
def test_wrapper_refuses_other_input(bad):
    with pytest.raises(ValueError, match="contiguous 1-D int32"):
        sc.mul_u32(bad, DEFAULT_FACTOR)
    with pytest.raises(ValueError, match="contiguous 1-D int32"):
        sc.unscramble(bad, DEFAULT_FACTOR)


def test_cuda_tensor_without_card_raises(monkeypatch):
    """A CUDA tensor launches the kernel or raises; it never takes the
    plain version.  A fake CUDA tensor stands in for a real one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel launches for real")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(sc, "mul_u32_torch", plain)
    monkeypatch.setattr(th, "mul_u32", plain)
    with FakeTensorMode():
        x = torch.zeros(100, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            sc.mul_u32(x, DEFAULT_FACTOR)
        with pytest.raises(RuntimeError, match="CUDA device"):
            sc.unscramble(x, DEFAULT_FACTOR)


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


PLAIN_TWINS = {
    "flat_to_rows_torch": lambda: cl.flat_to_rows_torch(
        _i32(100), _i32(100), 128, 8, DEFAULT_FACTOR),
    "flat_to_rows on the CPU": lambda: cl.flat_to_rows(
        _i32(100), _i32(100), 128, 8, DEFAULT_FACTOR),
    "merge_probe_torch": lambda: mp.merge_probe_torch(
        _i32(512), _i32(256), _i32(256), _i32(2), 256, 256),
    "merge_probe_gather's merge_probe_torch": lambda: mg.merge_probe_torch(
        _i32(512), _i32(256), _i32(256), _i32(2), 256, 256),
    "merge_probe_gather_indexed_torch":
        lambda: mg.merge_probe_gather_indexed_torch(
            _i32(512), _i32(256), _i32(256), _i32(3), _i32(3), _i32(512),
            _i32(512), 256, 256),
    "probe_tiles_torch": lambda: pt.probe_tiles_torch(
        _i32(512), _i32(4, 256), _i32(4, 256), _i32(4), 128),
    "radix_partition_torch": lambda: rp.radix_partition_torch(
        _i32(1000), _i32(1000), 6),
    "hashing.mul_u32": lambda: th.mul_u32(_i32(100), DEFAULT_FACTOR),
    "hashing.range_hash": lambda: th.range_hash(_i32(100), DEFAULT_FACTOR,
                                                1000),
    "hashing.hash_ratio": lambda: th.hash_ratio(_i32(100), DEFAULT_FACTOR,
                                                8, 0.5),
}


@pytest.mark.parametrize("name", sorted(PLAIN_TWINS))
def test_plain_versions_never_reach_the_kernel(monkeypatch, name):
    """The other kernels' plain versions (and range_hash, NPJ's hash)
    keep the int64 multiply, so the card's check of a kernel against its
    plain version never holds one kernel against another."""
    def refuse(*a, **k):
        raise AssertionError("reached ops.scramble.mul_u32")

    monkeypatch.setattr(sc, "mul_u32", refuse)
    PLAIN_TWINS[name]()
    # the check sees a caller that does reach it
    with pytest.raises(AssertionError, match="reached ops.scramble"):
        tphj.unscramble(_i32(8), DEFAULT_FACTOR)


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls of ops.scramble.mul_u32 (the CPU ones take the
    plain version)."""
    calls = []
    real = sc.mul_u32

    def counted(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(sc, "mul_u32", counted)
    return calls


def _relations(seed, ni=2048, no=16384):
    inner, outer, _ = generate(seed=seed, inner_tuples=ni, outer_tuples=no,
                               mode="uniform", prefer_native=False)
    return inner.keys, inner.vals, outer.keys, outer.vals


# the padded plans' JAX twin runs the jnp probe (Pallas needs interpret
# mode on the CPU)
PLANS = {
    "merge default": None,
    "padded sort": JoinPlan(p_bits=4, slots=512, tile=256, pass_bits=(4,),
                            partition_impl="sort", probe_impl="jnp"),
    "padded radix": JoinPlan(p_bits=6, slots=1024, tile=2048,
                             pass_bits=(3, 3), partition_impl="radix",
                             probe_impl="jnp"),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_join_unscrambles_through_the_wrapper_like_jax(spy, name):
    """join() on the CPU: its probe keys come from ops.scramble, one call
    over every probe slot, and equal the JAX join's slot for slot (radix
    runs keep input order where the JAX pass sorts them: there as a
    multiset); the check's monotonicity pass goes through it too."""
    cols = _relations(61)
    plan = PLANS[name]
    res_t, plan_t = tphj.join(*cols, plan=plan, device="cpu")
    assert spy == [res_t.probe_keys.shape[0]]
    res_j, _ = jphj.join(*cols, plan=JaxPlan(**dataclasses.asdict(plan_t)))
    got = result_to_numpy(res_t)
    want = {f: np.asarray(getattr(res_j, f)).reshape(-1)
            for f in ("probe_keys", "match_vals", "match_cnts")}
    if plan_t.partition_impl == "radix":
        got, want = ({f: np.sort(d[f]) for f in d} for d in (got, want))
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    stats = validate_join_result(res_t, cols[2], plan_t)
    if plan_t.probe_impl.startswith("merge"):
        assert stats["monotonicity"] == "checked"
        assert len(spy) == 2
    assert multiset_digest(*tphj.materialize(res_t)) == \
        multiset_digest(*join_oracle(*cols))


def test_stream_replay_unscrambles_through_the_wrapper(spy):
    ik, iv, ok, ov = _relations(62, no=4096)
    res, plan = tphj.join(ik, iv, ok, ov, device="cpu")
    cap = res.probe_keys.shape[0]
    spy.clear()
    keys, vals = tstream.replay_probe_columns(ok, ov, plan, cap,
                                              device="cpu")
    assert spy == [cap]
    np.testing.assert_array_equal(keys, to_numpy_u32(res.probe_keys))


@pytest.mark.parametrize("pack_impl", ["sort", "radix"])
def test_cpra_routes_owner_bits_and_buckets_through_the_wrapper(spy,
                                                                pack_impl):
    """Two gloo thread ranks: the owner bits (sort pack), the bucket
    scramble and the received buckets' unscramble (radix pack) and each
    rank's local unscramble take ops.scramble; the rows equal the
    oracle's."""
    ik, iv, ok, ov = _relations(63, no=8192)
    plan = JoinPlan(p_bits=4, slots=512, tile=256, pass_bits=(4,))

    def body(m):
        return tcpra.cpra_join(ik, iv, ok, ov, m, plan, slack=4.0,
                               pack_impl=pack_impl)[0]

    out = run_ranks(thread_meshes(2, "cpu", timeout_s=120), body,
                    timeout_s=300)
    # per rank: two owner or bucket passes, two unscrambles of the radix
    # pack's received buckets, one unscramble in the local join
    assert len(spy) == 2 * (3 if pack_impl == "sort" else 5)
    cols = [[], [], []]
    for res in out:
        m = res.match_cnts.numpy() == 1
        for c, t in zip(cols, (res.probe_keys, res.probe_vals,
                               res.match_vals)):
            c.append(to_numpy_u32(t)[m])
    assert multiset_digest(*(np.concatenate(c) for c in cols)) == \
        multiset_digest(*join_oracle(ik, iv, ok, ov))


@pytest.mark.parametrize("bits,shift", [(1, 0), (2, 0), (3, 1), (6, 0),
                                        (6, 26), (4, 28), (8, 24),
                                        (10, 3)])
def test_owner_bits_equal_the_int64_shift(bits, shift):
    """cpra._top_bits on the int32 product equals the logical shift of
    the unsigned key it replaced."""
    keys = _keys(seed=bits * 64 + shift)
    got = tcpra._top_bits(u32_to_device(keys, "cpu"), DEFAULT_FACTOR, bits,
                          shift)
    assert got.dtype == torch.int64
    hk = jh.np_hashed_key(keys, DEFAULT_FACTOR).astype(np.uint64)
    want = ((hk << np.uint64(shift)) & np.uint64(0xFFFFFFFF)) \
        >> np.uint64(32 - bits)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
