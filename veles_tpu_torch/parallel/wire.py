"""Binary payload codec of the distributed control plane
(``veles_tpu/parallel/wire.py``), byte-compatible with the JAX
package's: a blob either package encodes decodes in the other.

Payloads are pickles behind a one-byte codec tag: ``RAW``, ``ZLIB``
(level 1, for peers on other hosts), or ``OOB``, the out-of-band array
framing -- only the array-free *skeleton* of the tree is pickled, and
array leaves ride after it as raw 64-byte-aligned buffers described by
a small JSON table, so:

* :func:`encode_chunks` returns the payload as a scatter/gather list
  whose array parts are zero-copy ``memoryview``s of the source
  arrays -- the shared-memory path copies them straight into its
  segment, never building a pickle byte-string;
* :func:`decode` gives array leaves back as read-only zero-copy
  ``numpy.frombuffer`` views over the received buffer (consumers copy
  into their own tensors when applying).

Decoding is **restricted by default**: control-plane payloads are
numpy arrays plus JSON-shaped primitives, so :func:`decode` refuses to
reconstruct any other class (:class:`UnsafePayloadError`). The OOB
format does not widen that surface: its skeleton goes through the same
:class:`RestrictedUnpickler`, and its raw buffers only become arrays
through ``numpy.frombuffer`` with a validated non-object dtype and
bounds-checked offsets. Pass ``trusted=True`` only for blobs that
never crossed a network boundary.

bfloat16 without ``ml_dtypes``: numpy has no bfloat16, so the port
carries a bf16 leaf as its 16-bit patterns under the JAX package's
``"bfloat16"`` OOB token (:class:`BFloat16Bits`, always out-of-band),
and decodes one -- an OOB leaf with that token, or a small bf16 array
or scalar the JAX package pickled into the skeleton through
``ml_dtypes.bfloat16`` (resolved here to a local stand-in, never
imported) -- as its exact float32 widening. The float32 -> bf16 cast
is torch's on CPU tensors; it rounds to nearest even, as ``ml_dtypes``
does, so a base tracked by one package's :class:`DeltaEncoder` is
bit-identical to what the other's :class:`DeltaDecoder` rebuilds.
Payload leaves are numpy arrays only: tensors are converted at the
unit boundary.

On top of the transport, :class:`DeltaEncoder`/:class:`DeltaDecoder`
implement the master->slave parameter-delta exchange: after one full
push, updates carry per-leaf deltas with an exact dirty/epsilon skip
and an opt-in bf16 cast.
"""

import io
import json
import pickle
import struct
import zlib

import numpy
import torch

try:
    from numpy._core import multiarray as _multiarray
except ImportError:  # numpy 1.x
    from numpy.core import multiarray as _multiarray

RAW = b"\x00"
ZLIB = b"\x01"
#: out-of-band array framing (skeleton pickle + raw buffer table)
OOB = b"\x02"

#: magic prefix of an OOB body — lets :func:`decode` recognize an OOB
#: payload after zlib decompression (legacy ZLIB bodies are protocol-4
#: pickles, which always start with ``b"\x80\x04"``)
OOB_MAGIC = b"VOB1"

#: don't compress blobs smaller than this (codec overhead dominates)
MIN_COMPRESS = 4 * 1024

#: array leaves at least this large go out-of-band; smaller ones ride
#: the skeleton pickle (per-leaf table overhead dominates below this)
OOB_MIN_ARRAY = 512

#: leaf buffers are aligned to this inside the data section so decoded
#: views are cacheline-aligned when the containing buffer is
OOB_ALIGN = 64


class UnsafePayloadError(pickle.UnpicklingError):
    """A network payload referenced a class outside the allowlist."""


class _Leaf(object):
    """Skeleton placeholder for an out-of-band array leaf."""

    __slots__ = ("index",)

    def __init__(self, index):
        self.index = index

    def __reduce__(self):
        return (_Leaf, (self.index,))


#: the global a skeleton names its leaf placeholder by: the JAX
#: package's, so either package's decoder resolves the other's blobs
LEAF_GLOBAL = ("veles_tpu.parallel.wire", "_Leaf")
#: the bf16 dtype class the JAX package's pickles name
BF16_GLOBAL = ("ml_dtypes", "bfloat16")
#: the OOB table's token for a bf16 leaf
BF16_TOKEN = "bfloat16"


class BFloat16Bits(object):
    """A bfloat16 array as its 16-bit patterns (``bits``, uint16): what
    the port sends where the JAX package sends an ``ml_dtypes`` array.
    Always framed out-of-band under :data:`BF16_TOKEN`."""

    __slots__ = ("bits",)

    def __init__(self, bits):
        self.bits = numpy.ascontiguousarray(bits, dtype=numpy.uint16)


def to_bfloat16(values):
    """float ndarray -> (:class:`BFloat16Bits`, their widening back to
    ``values``' dtype): torch's round-to-nearest-even cast on a CPU
    tensor."""
    t = torch.from_numpy(numpy.ascontiguousarray(values))
    b = t.to(torch.bfloat16)
    return (BFloat16Bits(b.view(torch.int16).numpy().view(numpy.uint16)),
            b.to(t.dtype).numpy())


def bf16_widen(bits):
    """uint16 bf16 patterns -> the float32 values they hold, exactly."""
    bits = numpy.asarray(bits, numpy.uint16)
    return (bits.astype(numpy.uint32) << 16).view(numpy.float32)


class _BF16Type(object):
    """Stand-in for ``ml_dtypes.bfloat16`` in a JAX skeleton."""


class _BF16Dtype(object):
    """What ``numpy.dtype(ml_dtypes.bfloat16)`` unpickles to here."""

    def __setstate__(self, state):
        pass


_BF16_DTYPE = _BF16Dtype()


def _wire_dtype(obj, *args):
    if obj is _BF16Type:
        return _BF16_DTYPE
    return numpy.dtype(obj, *args)


class _WireArray(numpy.ndarray):
    """ndarray as the restricted unpickler rebuilds it: a bf16 state is
    widened to float32 (see :func:`_plain`)."""

    def __setstate__(self, state):
        if len(state) == 5 and state[2] is _BF16_DTYPE:
            version, shape, _, fortran, raw = state
            wide = bf16_widen(numpy.frombuffer(raw, "<u2"))
            state = (version, shape, numpy.dtype("<f4"), fortran,
                     wide.tobytes())
        super(_WireArray, self).__setstate__(state)


def _wire_reconstruct(subtype, shape, dtype):
    return _multiarray._reconstruct(_WireArray, shape, dtype)


def _wire_scalar(dtype, *args):
    if dtype is _BF16_DTYPE:
        return bf16_widen(numpy.frombuffer(args[0], "<u2"))[0]
    return _multiarray.scalar(dtype, *args)


def _plain(value):
    """The unpickled tree with every :class:`_WireArray` a plain
    ndarray view (through dicts, lists and tuples)."""
    if isinstance(value, _WireArray):
        return value.view(numpy.ndarray)
    if type(value) is dict:
        return {k: _plain(v) for k, v in value.items()}
    if type(value) is list:
        return [_plain(v) for v in value]
    if type(value) is tuple:
        return tuple(_plain(v) for v in value)
    return value


#: (module, qualname) pairs a control-plane payload may reconstruct.
#: numpy 2 pickles through ``numpy._core``; peers on numpy 1.x emit
#: ``numpy.core`` — both spellings are the same two functions.
SAFE_GLOBALS = {
    ("builtins", "complex"),
    ("builtins", "bytearray"),
    ("builtins", "set"),
    ("builtins", "frozenset"),
    ("builtins", "slice"),
    ("builtins", "range"),
    ("collections", "OrderedDict"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    # the OOB skeleton's array placeholder (data only: one int)
    LEAF_GLOBAL,
    # a bf16 array or scalar of the JAX package, resolved to the local
    # stand-in (plain data, no code execution; ml_dtypes never loads)
    BF16_GLOBAL,
}

#: allowlisted globals resolved to this module's stand-ins
_LOCAL_GLOBALS = {
    LEAF_GLOBAL: _Leaf,
    BF16_GLOBAL: _BF16Type,
    ("numpy", "dtype"): _wire_dtype,
    ("numpy._core.multiarray", "_reconstruct"): _wire_reconstruct,
    ("numpy.core.multiarray", "_reconstruct"): _wire_reconstruct,
    ("numpy._core.multiarray", "scalar"): _wire_scalar,
    ("numpy.core.multiarray", "scalar"): _wire_scalar,
}


class RestrictedUnpickler(pickle.Unpickler):
    """Allowlist unpickler: numpy + basic containers, nothing else."""

    def find_class(self, module, name):
        if (module, name) in _LOCAL_GLOBALS:
            return _LOCAL_GLOBALS[module, name]
        if (module, name) in SAFE_GLOBALS or (
                # numpy 2 moved dtype classes to numpy.dtypes
                # (Float32DType etc.) — plain data, no code execution
                module == "numpy.dtypes" and name.endswith("DType")):
            return super(RestrictedUnpickler, self).find_class(
                module, name)
        raise UnsafePayloadError(
            "payload references forbidden global %s.%s" % (module, name))


def _restricted_loads(payload):
    return _plain(RestrictedUnpickler(io.BytesIO(payload)).load())


class _TrustedUnpickler(pickle.Unpickler):
    """Any global, with the wire's own names (the leaf placeholder, the
    JAX package's bf16) resolved to this module's stand-ins."""

    def find_class(self, module, name):
        if (module, name) in _LOCAL_GLOBALS:
            return _LOCAL_GLOBALS[module, name]
        return super(_TrustedUnpickler, self).find_class(module, name)


class _SkeletonPickler(pickle._Pickler):
    """Pickles a skeleton with its leaf placeholders named
    :data:`LEAF_GLOBAL` (the pure-Python pickler: the C one would look
    that module up, and the port never imports the JAX package)."""

    def save_global(self, obj, name=None):
        if obj is not _Leaf:
            return super(_SkeletonPickler, self).save_global(obj, name)
        self.save(LEAF_GLOBAL[0])
        self.save(LEAF_GLOBAL[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _dump_skeleton(skeleton):
    out = io.BytesIO()
    _SkeletonPickler(out, protocol=4).dump(skeleton)
    return out.getvalue()


# -- out-of-band framing -----------------------------------------------------


class Chunks(object):
    """One logical blob as a scatter/gather list of buffers.

    The first part is the codec tag + OOB header; the rest are raw
    array buffers (zero-copy ``memoryview``s of the source arrays) and
    their alignment padding. A transport that can write vectored
    (:meth:`Protocol.send`'s shm/frame paths) streams the parts
    straight to their destination; :meth:`join` materializes one bytes
    object for transports that cannot.
    """

    __slots__ = ("parts", "nbytes")

    def __init__(self, parts):
        self.parts = [self._as_bytes_view(p) for p in parts]
        self.nbytes = sum(len(p) for p in self.parts)

    @staticmethod
    def _as_bytes_view(part):
        if isinstance(part, bytes):
            return part
        if isinstance(part, numpy.ndarray):
            part = numpy.ascontiguousarray(part)
            if part.dtype.kind == "V":
                # extension dtypes (bf16) export no buffer; their bytes
                # are still a plain uint8 view away
                part = part.view(numpy.uint8)
        return memoryview(part).cast("B")

    def join(self):
        return b"".join(self.parts)


def _dtype_token(dtype):
    """Wire name for a dtype, or None if it cannot go out-of-band."""
    if dtype.hasobject:
        return None
    if dtype.kind in "Mm":
        # datetime64/timedelta64 export no buffer (memoryview refuses
        # kind 'M'/'m'); the skeleton pickle handles them as before
        return None
    if dtype.kind == "V":
        # extension dtypes stringify ambiguously ('<V2'): a bf16 leaf
        # goes out-of-band only as BFloat16Bits
        return None
    return dtype.str


def _resolve_dtype(token):
    """Wire name -> dtype, refusing anything that could smuggle
    object references past the restricted unpickler (the bf16 token
    reads as uint16 patterns, widened by the caller)."""
    if token == BF16_TOKEN:
        return numpy.dtype("<u2")
    try:
        dtype = numpy.dtype(str(token))
    except (TypeError, ValueError) as e:
        raise UnsafePayloadError("bad OOB dtype %r: %s" % (token, e))
    if dtype.hasobject:
        raise UnsafePayloadError("object dtype %r refused" % (token,))
    return dtype


def _extract(value, leaves):
    """Replace extractable array leaves with :class:`_Leaf` markers.

    Only plain dict/list/tuple containers are walked (rebuilt with the
    same type); anything else — including OrderedDicts, sets and
    arrays below :data:`OOB_MIN_ARRAY` — stays in the skeleton pickle
    untouched, so the format degrades gracefully to the legacy one.
    """
    if isinstance(value, BFloat16Bits):
        leaves.append(value)
        return _Leaf(len(leaves) - 1)
    if isinstance(value, numpy.ndarray) and \
            value.nbytes >= OOB_MIN_ARRAY and \
            _dtype_token(value.dtype) is not None:
        leaves.append(numpy.ascontiguousarray(value))
        return _Leaf(len(leaves) - 1)
    if type(value) is dict:
        return {k: _extract(v, leaves) for k, v in value.items()}
    if type(value) is list:
        return [_extract(v, leaves) for v in value]
    if type(value) is tuple:
        return tuple(_extract(v, leaves) for v in value)
    return value


def _substitute(value, leaves):
    if isinstance(value, _Leaf):
        index = value.index
        if not (isinstance(index, int) and 0 <= index < len(leaves)):
            raise UnsafePayloadError(
                "OOB leaf index %r out of range" % (index,))
        return leaves[index]
    if type(value) is dict:
        return {k: _substitute(v, leaves) for k, v in value.items()}
    if type(value) is list:
        return [_substitute(v, leaves) for v in value]
    if type(value) is tuple:
        return tuple(_substitute(v, leaves) for v in value)
    return value


def _oob_parts(obj):
    """obj -> Chunks (tag + header + skeleton, then raw leaf buffers),
    or None when nothing is worth framing out-of-band."""
    leaves = []
    skeleton = _extract(obj, leaves)
    if not leaves:
        return None
    skel = _dump_skeleton(skeleton)
    table = []
    offset = 0
    for i, arr in enumerate(leaves):
        token = _dtype_token(arr.dtype) \
            if isinstance(arr, numpy.ndarray) else BF16_TOKEN
        if token == BF16_TOKEN:
            arr = leaves[i] = arr.bits
        offset += (-offset) % OOB_ALIGN
        table.append([token, list(arr.shape), offset, arr.nbytes])
        offset += arr.nbytes
    # data_off is provisional: meta's own length shifts it, so compute
    # with a fixed-point — data_off's digit count is nondecreasing and
    # bounded, so this converges (in practice on the second pass).
    # Alignment is computed over the WHOLE blob including the 1-byte
    # codec tag (data_off itself stays relative to the body, i.e. the
    # magic): leaf views decoded from the contiguous blob then sit at
    # OOB_ALIGN boundaries of the blob, not one byte off them.
    head_len = 1 + len(OOB_MAGIC) + 4
    data_off = 0
    while True:
        meta = json.dumps({"skel": len(skel), "data": data_off,
                           "leaves": table},
                          separators=(",", ":")).encode()
        base = head_len + len(meta) + len(skel)
        new_off = base + ((-base) % OOB_ALIGN) - 1
        if new_off == data_off:
            break
        data_off = new_off
    header = b"".join([
        OOB, OOB_MAGIC, struct.pack("<I", len(meta)), meta, skel,
        b"\x00" * (data_off + 1 - (head_len + len(meta) + len(skel)))])
    parts = [header]
    pos = 0
    for arr, entry in zip(leaves, table):
        pad = entry[2] - pos
        if pad:
            parts.append(b"\x00" * pad)
        parts.append(arr)
        pos = entry[2] + arr.nbytes
    return Chunks(parts)


def _decode_oob(body, trusted):
    """OOB body (magic onward, buffer-like) -> object with zero-copy
    ``frombuffer`` array views over ``body``."""
    view = memoryview(body)
    if len(view) < len(OOB_MAGIC) + 4:
        raise UnsafePayloadError("truncated OOB header")
    (meta_len,) = struct.unpack_from("<I", view, len(OOB_MAGIC))
    meta_off = len(OOB_MAGIC) + 4
    if meta_off + meta_len > len(view):
        raise UnsafePayloadError("OOB meta overruns payload")
    try:
        meta = json.loads(bytes(view[meta_off:meta_off + meta_len]))
        skel_len = int(meta["skel"])
        data_off = int(meta["data"])
        entries = list(meta["leaves"])
    except (ValueError, KeyError, TypeError) as e:
        raise UnsafePayloadError("malformed OOB meta: %s" % e)
    skel_off = meta_off + meta_len
    if not (0 <= skel_len and skel_off + skel_len <= len(view) and
            0 <= data_off <= len(view)):
        raise UnsafePayloadError("OOB skeleton overruns payload")
    skel = bytes(view[skel_off:skel_off + skel_len])
    skeleton = _restricted_loads(skel) if not trusted else \
        _plain(_TrustedUnpickler(io.BytesIO(skel)).load())
    data = view[data_off:]
    leaves = []
    for entry in entries:
        try:
            token, shape, offset, nbytes = entry
            shape = tuple(int(s) for s in shape)
            offset, nbytes = int(offset), int(nbytes)
        except (ValueError, TypeError) as e:
            raise UnsafePayloadError("malformed OOB leaf entry: %s" % e)
        dtype = _resolve_dtype(token)
        count = 1
        for s in shape:
            if s < 0:
                raise UnsafePayloadError("negative OOB dim %d" % s)
            count *= s
        if nbytes != count * dtype.itemsize or offset < 0 or \
                offset + nbytes > len(data):
            raise UnsafePayloadError(
                "OOB leaf out of bounds: off=%d nbytes=%d data=%d"
                % (offset, nbytes, len(data)))
        leaf = numpy.frombuffer(data[offset:offset + nbytes], dtype=dtype,
                                count=count).reshape(shape)
        leaves.append(bf16_widen(leaf) if token == BF16_TOKEN else leaf)
    return _substitute(skeleton, leaves)


# -- public codec ------------------------------------------------------------


def encode_chunks(obj):
    """Object -> :class:`Chunks` for vectored (zero-copy) transports.

    Array leaves are referenced, not copied — the caller must keep the
    source arrays unmodified until the chunks are written out (the
    Protocol writes under its send lock within the same call). Falls
    back to a single legacy-pickle part when nothing is extractable.
    """
    parts = _oob_parts(obj)
    if parts is not None:
        return parts
    return Chunks([RAW + pickle.dumps(obj, protocol=4)])


def encode(obj, compress=True):
    """Object -> tagged bytes."""
    parts = _oob_parts(obj)
    if parts is None:
        payload = RAW + pickle.dumps(obj, protocol=4)
    else:
        payload = parts.join()
    if compress and len(payload) >= MIN_COMPRESS:
        # memoryview slice: don't memcpy a 250 MB payload just to
        # strip the 1-byte tag before zlib
        packed = zlib.compress(memoryview(payload)[1:], 1)
        if len(packed) < len(payload) - 1:
            return ZLIB + packed
    return payload


def decode(blob, trusted=False):
    """Tagged bytes -> object (allowlist-unpickled unless ``trusted``).

    Array leaves of OOB payloads come back as read-only zero-copy
    views over ``blob`` — consumers that need to mutate must copy.
    """
    if isinstance(blob, Chunks):
        blob = blob.join()
    if isinstance(blob, str):
        # a peer that fell back to text framing (or a shm segment read
        # as text) delivers latin-1; recover the raw bytes
        blob = blob.encode("latin-1")
    view = memoryview(blob)
    tag, payload = bytes(view[:1]), view[1:]
    if tag == ZLIB:
        payload = memoryview(zlib.decompress(payload))
    elif tag == OOB:
        return _decode_oob(payload, trusted)
    elif tag != RAW:
        raise ValueError("unknown wire codec tag %r" % tag)
    if bytes(payload[:len(OOB_MAGIC)]) == OOB_MAGIC:
        # zlib-compressed OOB body (cross-host path)
        return _decode_oob(payload, trusted)
    if trusted:
        return _plain(_TrustedUnpickler(io.BytesIO(payload)).load())
    return _restricted_loads(payload)


# -- parameter-delta exchange ------------------------------------------------

#: delta wire markers (plain dicts: survive any codec, no new pickle
#: surface); a user dict carrying one of these keys is escaped
_D_KEEP = "__dkeep__"
_D_ADD = "__dadd__"
_D_ESC = "__desc__"
_D_WRAP = "__wire_delta__"


def _is_marker(value):
    return type(value) is dict and (
        (_D_KEEP in value or _D_ADD in value or _D_ESC in value)
        and len(value) == 1)


def _deltable(value):
    """Float arrays are delta-coded; ints (indices/labels) and
    everything else travel verbatim."""
    return isinstance(value, numpy.ndarray) and value.dtype.kind == "f" \
        and value.size > 0


class DeltaEncoder(object):
    """Master-side per-peer parameter-delta codec.

    The first :meth:`encode` sends the tree in full; afterwards every
    float-array leaf whose path/shape/dtype matches the previous push
    is replaced by its delta — skipped entirely when it moved by at
    most ``eps`` (0.0 = exact dirty check), optionally cast to
    ``dtype`` (bf16 halves master->slave bytes).

    The tracked base is always the value the *peer* reconstructs
    (``base + cast(delta)``), never the true local value — so cast
    error stays bounded by one quantization of a single delta instead
    of accumulating across pushes, exactly like the decoder's
    arithmetic (same numpy ops, bit-identical).
    """

    def __init__(self, dtype=None, eps=0.0):
        if dtype is not None and dtype != BF16_TOKEN:
            dtype = numpy.dtype(dtype)
        #: None, a numpy dtype, or :data:`BF16_TOKEN`
        self.dtype = dtype
        self.eps = float(eps)
        self.leaves_sent = 0
        self.leaves_skipped = 0
        self._base = None

    def encode(self, tree):
        full = self._base is None
        base = {} if full else self._base
        new_base = {}
        out = self._walk(tree, (), base, new_base, full)
        self._base = new_base
        return {_D_WRAP: 1, "kind": "full" if full else "delta",
                "tree": out}

    def _walk(self, value, path, base, new_base, full):
        if _deltable(value):
            prev = base.get(path)
            if full or prev is None or prev.shape != value.shape or \
                    prev.dtype != value.dtype:
                # the stored base must be immune to later in-place
                # mutation of the caller's array
                new_base[path] = numpy.array(value)
                self.leaves_sent += 1
                return value
            delta = value - prev
            moved = float(numpy.abs(delta).max()) if delta.size else 0.0
            if moved <= self.eps:
                new_base[path] = prev
                self.leaves_skipped += 1
                return {_D_KEEP: 1}
            if self.dtype == BF16_TOKEN:
                delta, wide = to_bfloat16(delta)
                new_base[path] = prev + wide.astype(prev.dtype, copy=False)
                self.leaves_sent += 1
                return {_D_ADD: delta}
            if self.dtype is not None and self.dtype != value.dtype:
                delta = delta.astype(self.dtype)
            new_base[path] = prev + delta.astype(prev.dtype, copy=False)
            self.leaves_sent += 1
            return {_D_ADD: delta}
        if type(value) is dict:
            out = {k: self._walk(v, path + (k,), base, new_base, full)
                   for k, v in value.items()}
            if _is_marker(value) or _D_WRAP in value:
                return {_D_ESC: out}
            return out
        if type(value) in (list, tuple):
            out = [self._walk(v, path + (i,), base, new_base, full)
                   for i, v in enumerate(value)]
            return out if type(value) is list else tuple(out)
        return value


class DeltaDecoder(object):
    """Peer-side mirror of :class:`DeltaEncoder`.

    Trees that never went through a DeltaEncoder pass through
    unchanged, so a delta-aware slave serves a legacy master.
    """

    def __init__(self):
        self._base = None

    def decode(self, msg):
        if not (type(msg) is dict and msg.get(_D_WRAP) == 1):
            return msg
        full = msg.get("kind") == "full"
        if not full and self._base is None:
            raise ValueError("delta push before any full push")
        base = {} if full else self._base
        new_base = {}
        out = self._walk(msg.get("tree"), (), base, new_base)
        self._base = new_base
        return out

    def _walk(self, value, path, base, new_base):
        if _is_marker(value):
            if _D_ESC in value:
                return {k: self._walk(v, path + (k,), base, new_base)
                        for k, v in value[_D_ESC].items()}
            prev = base.get(path)
            if prev is None:
                raise ValueError("delta for unknown leaf at %r" % (path,))
            if _D_KEEP in value:
                new_base[path] = prev
                return prev
            delta = value[_D_ADD]
            recon = prev + numpy.asarray(delta).astype(prev.dtype,
                                                       copy=False)
            new_base[path] = recon
            return recon
        if _deltable(value):
            new_base[path] = value
            return value
        if type(value) is dict:
            return {k: self._walk(v, path + (k,), base, new_base)
                    for k, v in value.items()}
        if type(value) is list:
            return [self._walk(v, path + (i,), base, new_base)
                    for i, v in enumerate(value)]
        if type(value) is tuple:
            return tuple(self._walk(v, path + (i,), base, new_base)
                         for i, v in enumerate(value))
        return value
