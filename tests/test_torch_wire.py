"""The port's control-plane codec (``veles_tpu_torch/parallel/wire.py``)
against the JAX package's (``veles_tpu/parallel/wire.py``).

* Round trips of every payload shape, with the encoder and the decoder
  each taken from either package (``port->port``, ``jax->port``,
  ``port->jax``): OOB, zlib and raw framing, ``encode_chunks``,
  zero-copy aligned views.
* The restricted unpickler's refusals (``tests/test_wire.py``,
  ``tests/test_control_plane_security.py``): forbidden globals, reduce
  gadgets, object dtypes, out-of-bounds leaves; the allowlist gains no
  ``torch`` name and ``ml_dtypes`` never loads in the port.
* bfloat16 without ``ml_dtypes``: the JAX package's bf16 leaves (out of
  band, and small ones pickled into the skeleton, arrays and scalars)
  decode in the port as their exact float32 widening; the port's bf16
  deltas decode in the JAX package as ``ml_dtypes`` arrays; the base a
  :class:`DeltaEncoder` tracks is bit-identical to the one the other
  package's :class:`DeltaDecoder` rebuilds, both ways, over several
  pushes, compressed or not.

Equality is exact throughout (bf16 -> float32 is exact); the only
tolerance is the one-push bf16 quantization bound, 1e-3 on deltas of
0.01, as in ``tests/test_wire.py``.
"""

import json
import os
import pickle
import struct
import subprocess
import sys
import zlib

import ml_dtypes
import numpy
import pytest

from veles_tpu.parallel import wire as jax_wire
from veles_tpu_torch.parallel import wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = numpy.random.RandomState(7)

#: (encoder, decoder) module pairs
PAIRS = {"port->port": (wire, wire), "jax->port": (jax_wire, wire),
         "port->jax": (wire, jax_wire)}


@pytest.fixture(params=sorted(PAIRS))
def pair(request):
    return PAIRS[request.param]


def _assert_tree_equal(a, b):
    if isinstance(a, numpy.ndarray):
        assert isinstance(b, numpy.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        numpy.testing.assert_array_equal(a, b)
        return
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a == b


def _job():
    return {
        "units": [
            ("gd_fc1", {"weights": RNG.randn(300, 400).astype("f4"),
                        "bias": RNG.randn(400).astype("f4")}),
            ("decision", {"reset_complete": True, "stats": [0.5, 2]})],
        "batches": [{"indices": numpy.arange(500, dtype=numpy.int32),
                     "size": 500, "class": 2, "last": False, "epoch": 3,
                     "epoch_ended": False}]}


# -- round trips across the packages -----------------------------------------

@pytest.mark.parametrize("compress", [False, True])
def test_segment_job_roundtrips(pair, compress):
    enc, dec = pair
    job = _job()
    blob = enc.encode(job, compress=compress)
    assert blob[:1] == (wire.ZLIB if compress else wire.OOB)
    _assert_tree_equal(dec.decode(blob), job)


def test_chunks_roundtrip_and_join_parity(pair):
    enc, dec = pair
    job = _job()
    chunks = enc.encode_chunks(job)
    assert chunks.join() == enc.encode(job, compress=False)
    _assert_tree_equal(dec.decode(chunks.join()), job)


def test_update_shape_and_small_leaves(pair):
    """The slave->master update (gd deltas, decision stats, loader
    count), with leaves under the OOB threshold in the skeleton."""
    enc, dec = pair
    update = [("gd_fc1", {"weights": RNG.randn(100, 50).astype("f4"),
                          "bias": RNG.randn(10).astype("f4")}),
              ("decision", [{"klass": 2, "samples": 500, "metric": 0.25,
                             "loss": 1.5, "epoch": 0}]),
              ("loader", {"served": 4000, "count": 8}),
              ("tiny", {"x": numpy.array(3.5), "y": numpy.float64(0.25),
                        "i": numpy.int32(4)})]
    _assert_tree_equal(dec.decode(enc.encode(update, compress=False)),
                       update)


def test_mixed_dtypes_and_views(pair):
    enc, dec = pair
    base = RNG.randn(64, 64).astype("f4")
    tree = {"f8": RNG.randn(300), "i8": numpy.arange(200, dtype="i8"),
            "u1": numpy.arange(256, dtype="u1").repeat(4),
            "b": numpy.tile([True, False], 400),
            "c8": (RNG.randn(200) + 1j * RNG.randn(200)).astype("c8"),
            "strided": base[::2, ::3], "t": base.T,
            "when": numpy.zeros(200, dtype="datetime64[D]")}
    out = dec.decode(enc.encode(tree, compress=False))
    for k in tree:
        numpy.testing.assert_array_equal(out[k], tree[k])


def test_empty_and_array_free_payloads(pair):
    enc, dec = pair
    for obj in ({}, [], (), {"a": {}}, None, {"cmd": "heartbeat",
                                             "power": 2.0}):
        assert dec.decode(enc.encode(obj, compress=False)) == obj
        assert dec.decode(enc.encode_chunks(obj).join()) == obj


def test_decoded_leaves_are_aligned_zero_copy_views():
    tree = {"a": RNG.randn(300).astype("f4"),
            "b": RNG.randn(777).astype("f8")}
    blob = wire.encode(tree, compress=False)
    out = wire.decode(blob)
    base = numpy.frombuffer(blob, dtype=numpy.uint8)
    for arr in out.values():
        assert not arr.flags.owndata and not arr.flags.writeable
        off = (arr.__array_interface__["data"][0] -
               base.__array_interface__["data"][0])
        assert 0 < off < len(blob) and off % wire.OOB_ALIGN == 0


def test_port_blobs_are_byte_equal_to_jax_blobs():
    """Without bf16 the two encoders write the same bytes: the port
    names its leaf placeholder as the JAX package does."""
    job = _job()
    assert wire.encode(job, compress=False) == \
        jax_wire.encode(job, compress=False)
    assert wire.encode(job) == jax_wire.encode(job)


def test_legacy_pickle_blobs_decode():
    tree = {"a": numpy.arange(5), "b": "x"}
    _assert_tree_equal(wire.decode(wire.RAW + pickle.dumps(tree, 4)), tree)
    packed = wire.ZLIB + zlib.compress(pickle.dumps(tree, protocol=4), 1)
    _assert_tree_equal(wire.decode(packed), tree)


def test_trusted_decode_escape_hatch():
    blob = wire.RAW + pickle.dumps({"s": {1, 2}, "r": range(3)})
    assert wire.decode(blob, trusted=True) == {"s": {1, 2}, "r": range(3)}


# -- refusals ----------------------------------------------------------------

def _oob_blob(meta, skel, data=b""):
    meta_b = json.dumps(meta, separators=(",", ":")).encode()
    return (wire.OOB + wire.OOB_MAGIC + struct.pack("<I", len(meta_b)) +
            meta_b + skel + data)


class _Gadget(object):
    def __reduce__(self):
        return (print, ("pwned",))


@pytest.mark.parametrize("payload", [
    pickle.dumps(os.system), pickle.dumps({"g": _Gadget()}),
    pickle.dumps(pickle.loads), pickle.dumps(subprocess.Popen)])
def test_raw_forbidden_globals_refused(payload):
    with pytest.raises(wire.UnsafePayloadError):
        wire.decode(wire.RAW + payload)
    with pytest.raises(wire.UnsafePayloadError):
        wire.decode(_oob_blob({"skel": len(payload), "data": 0,
                               "leaves": []}, payload))


def test_object_dtype_and_bounds_refused():
    skel = pickle.dumps(jax_wire._Leaf(0), protocol=4)
    with pytest.raises(wire.UnsafePayloadError, match="dtype"):
        wire.decode(_oob_blob({"skel": len(skel), "data": 0,
                               "leaves": [["O", [1], 0, 8]]}, skel,
                              b"\x00" * 64))
    with pytest.raises(wire.UnsafePayloadError, match="bounds"):
        wire.decode(_oob_blob({"skel": len(skel), "data": 0,
                               "leaves": [["<f4", [1 << 20], 0, 4 << 20]]},
                              skel, b"\x00" * 64))
    with pytest.raises(wire.UnsafePayloadError, match="bounds"):
        wire.decode(_oob_blob({"skel": len(skel), "data": 0,
                               "leaves": [["bfloat16", [100], 0, 200]]},
                              skel, b"\x00" * 64))
    skel5 = pickle.dumps(jax_wire._Leaf(5), protocol=4)
    with pytest.raises(wire.UnsafePayloadError, match="range"):
        wire.decode(_oob_blob({"skel": len(skel5), "data": 0,
                               "leaves": []}, skel5))
    with pytest.raises(wire.UnsafePayloadError):
        wire.decode(wire.OOB + wire.OOB_MAGIC + b"\x01")


def test_allowlist_has_no_torch_and_names_leaf_as_jax():
    """The allowlist is the JAX package's (its leaf placeholder's name,
    ``ml_dtypes.bfloat16`` resolved to a local stand-in): no ``torch``
    name; the port's own module name and its bf16 carrier are refused
    in a skeleton."""
    assert wire.SAFE_GLOBALS == jax_wire.SAFE_GLOBALS
    assert not any(m.startswith("torch") for m, _ in wire.SAFE_GLOBALS)
    skel = wire._dump_skeleton([wire._Leaf(0)])
    assert b"veles_tpu.parallel.wire" in skel
    assert b"veles_tpu_torch" not in skel
    with pytest.raises(wire.UnsafePayloadError, match="veles_tpu_torch"):
        wire._restricted_loads(pickle.dumps(wire._Leaf(0), protocol=4))
    with pytest.raises(wire.UnsafePayloadError):
        wire._restricted_loads(pickle.dumps(wire.BFloat16Bits(
            numpy.zeros(2, numpy.uint16))))


def test_port_decodes_bf16_without_ml_dtypes():
    """In a fresh interpreter the port's wire decodes a JAX bf16 blob
    (out-of-band and skeleton leaves) without importing ``ml_dtypes``,
    ``jax`` or any ``veles_tpu`` module."""
    x = RNG.randn(700).astype(numpy.float32)
    blob = jax_wire.encode({"big": x.astype(ml_dtypes.bfloat16),
                            "small": x[:5].astype(ml_dtypes.bfloat16),
                            "s": x[0].astype(ml_dtypes.bfloat16)},
                           compress=True)
    want = x.astype(ml_dtypes.bfloat16).astype(numpy.float32)
    code = (
        "import sys, numpy\n"
        "from veles_tpu_torch.parallel import wire\n"
        "out = wire.decode(sys.stdin.buffer.read())\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'ml_dtypes' "
        "or m.startswith(('jax.', 'veles_tpu.'))]\n"
        "assert not bad, bad\n"
        "numpy.save(sys.stdout.buffer, numpy.concatenate("
        "[out['big'], out['small'], [out['s']]]))\n")
    proc = subprocess.run([sys.executable, "-c", code], input=blob,
                          capture_output=True, cwd=REPO, timeout=60,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr.decode()
    import io
    got = numpy.load(io.BytesIO(proc.stdout))
    numpy.testing.assert_array_equal(
        got, numpy.concatenate([want, want[:5], want[:1]]))
    assert got.dtype == numpy.float32


# -- bfloat16 across the packages --------------------------------------------

@pytest.mark.parametrize("n", [3, 255, 256, 5000])
@pytest.mark.parametrize("compress", [False, True])
def test_jax_bf16_leaves_decode_in_port_as_exact_float32(n, compress):
    """Out-of-band (n >= 256) and skeleton (n < 256) bf16 arrays and a
    bf16 scalar of the JAX package: their float32 widening, bit for
    bit."""
    x = (RNG.randn(n) * 10.0 ** RNG.randint(-30, 30, n)).astype("f4")
    b = x.astype(ml_dtypes.bfloat16)
    out = wire.decode(jax_wire.encode({"d": b, "s": b[-1]},
                                      compress=compress))
    assert out["d"].dtype == numpy.float32
    assert out["d"].tobytes() == b.astype(numpy.float32).tobytes()
    assert numpy.float32(out["s"]).tobytes() == \
        numpy.float32(b[-1]).tobytes()


def test_port_bf16_cast_is_ml_dtypes_rounding():
    """torch's float32 -> bf16 cast rounds as ``ml_dtypes``' does, ties
    to even, subnormals and extremes included."""
    bits = numpy.concatenate([
        RNG.randint(0, 1 << 32, 200000, dtype=numpy.uint64).astype(
            numpy.uint32),
        numpy.array([0x3F808000, 0x3F818000, 0x00008000, 0x00018000,
                     0x7F7FFFFF, 0x80000001, 0x007FFFFF], numpy.uint32)])
    x = bits.view(numpy.float32)
    x = x[numpy.isfinite(x)]
    packed, wide = wire.to_bfloat16(x)
    ref = x.astype(ml_dtypes.bfloat16)
    numpy.testing.assert_array_equal(packed.bits, ref.view(numpy.uint16))
    assert wide.tobytes() == ref.astype(numpy.float32).tobytes()


def test_port_bf16_delta_decodes_in_jax_as_ml_dtypes():
    w0 = RNG.randn(64, 32).astype("f4")
    enc = wire.DeltaEncoder(dtype="bfloat16")
    enc.encode({"w": w0, "b": w0[0]})
    msg = enc.encode({"w": w0 + 0.01, "b": w0[0] + 0.01})
    out = jax_wire.decode(wire.encode_chunks(msg).join())
    for key in ("w", "b"):   # 4 KiB out of band, 64 B forced so too
        leaf = out["tree"][key][jax_wire._D_ADD]
        assert leaf.dtype == numpy.dtype(ml_dtypes.bfloat16)
    assert out["tree"]["w"][jax_wire._D_ADD].shape == (64, 32)


def _walk_pushes(enc, dec, enc_mod, dec_mod, compress, steps=4):
    w = {"w": RNG.randn(50, 7).astype("f4"), "b": RNG.randn(7).astype("f4"),
         "k": numpy.arange(5, dtype=numpy.int32)}
    for step in range(steps):
        msg = enc.encode(w)
        blob = enc_mod.encode(msg, compress=compress) if compress is not \
            None else enc_mod.encode_chunks(msg).join()
        got = dec.decode(dec_mod.decode(blob))
        for k in ("w", "b"):
            assert got[k].tobytes() == enc._base[(k,)].tobytes(), \
                (k, step)
            assert numpy.abs(got[k] - w[k]).max() < 1e-3
        numpy.testing.assert_array_equal(got["k"], w["k"])
        w = {k: v + RNG.randn(*v.shape).astype("f4") * 0.01
             if v.dtype.kind == "f" else v for k, v in w.items()}


@pytest.mark.parametrize("direction", ["port->jax", "jax->port",
                                       "port->port"])
@pytest.mark.parametrize("compress", [None, False, True])
def test_bf16_delta_base_bit_identical_on_both_ends(direction, compress):
    """The encoder's tracked base (what it believes the peer holds) is
    the decoder's rebuild, bit for bit, over four pushes."""
    enc_mod, dec_mod = PAIRS[direction]
    _walk_pushes(enc_mod.DeltaEncoder(dtype="bfloat16"),
                 dec_mod.DeltaDecoder(), enc_mod, dec_mod, compress)


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_float32_delta_crosses_exactly(direction):
    enc_mod, dec_mod = PAIRS[direction]
    enc, dec = enc_mod.DeltaEncoder(dtype="float32"), dec_mod.DeltaDecoder()
    w0 = RNG.randn(100, 50).astype("f4")
    dec.decode(dec_mod.decode(enc_mod.encode(enc.encode({"w": w0}))))
    w1 = w0 + RNG.randn(*w0.shape).astype("f4") * 0.01
    got = dec.decode(dec_mod.decode(enc_mod.encode(enc.encode({"w": w1}))))
    assert got["w"].tobytes() == (w0 + (w1 - w0)).tobytes()


def test_port_delta_encoder_matches_jax_delta_encoder():
    """Fed the same trees, the two encoders skip and send the same
    leaves and track the same bases."""
    jenc = jax_wire.DeltaEncoder(dtype="bfloat16", eps=1e-4)
    penc = wire.DeltaEncoder(dtype="bfloat16", eps=1e-4)
    w = {"w": RNG.randn(40, 40).astype("f4"), "b": RNG.randn(40).astype("f4")}
    for step in range(3):
        jenc.encode(w)
        penc.encode(w)
        for k in jenc._base:
            assert jenc._base[k].tobytes() == penc._base[k].tobytes()
        w = {"w": w["w"] + 0.01, "b": w["b"] + 1e-5}
    assert (jenc.leaves_sent, jenc.leaves_skipped) == \
        (penc.leaves_sent, penc.leaves_skipped)


def test_delta_protocol_edges():
    dec = wire.DeltaDecoder()
    msg = {"plain": 1}
    assert dec.decode(msg) is msg
    with pytest.raises(ValueError, match="full"):
        dec.decode({wire._D_WRAP: 1, "kind": "delta", "tree": {}})
    enc, dec = wire.DeltaEncoder(), wire.DeltaDecoder()
    tree = {"cfg": {"__dkeep__": 1}, "w": RNG.randn(16).astype("f4")}
    assert dec.decode(enc.encode(tree))["cfg"] == {"__dkeep__": 1}
    assert dec.decode(enc.encode(tree))["cfg"] == {"__dkeep__": 1}
    dec.decode(enc.encode({"w": RNG.randn(8, 8).astype("f4")}))
    new = RNG.randn(3, 5).astype("f4")
    numpy.testing.assert_array_equal(dec.decode(enc.encode({"w": new}))["w"],
                                     new)


def test_bf16_delta_halves_wire_bytes():
    w0 = RNG.randn(256, 256).astype("f4")
    enc = wire.DeltaEncoder(dtype="bfloat16")
    enc.encode({"w": w0})
    delta = wire.encode_chunks(enc.encode({"w": w0 + 0.01})).nbytes
    assert delta < 0.6 * wire.encode_chunks({"w": w0 + 0.01}).nbytes
