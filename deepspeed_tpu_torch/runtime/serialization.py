"""flax's msgpack layout, written with the standard library (counterpart
of ``flax.serialization.to_bytes`` / ``msgpack_serialize``, which the JAX
engine's ``save_16bit_model`` uses; the port imports neither flax nor the
``msgpack`` package).

``to_bytes(tree)`` encodes a tree of dicts with str keys, sorted at every
level as ``jax.tree_util`` orders them, whose leaves are tensors (or
ints, strings, bytes and lists of them). A tensor is msgpack ext type 1
holding ``packb((shape, dtype_name, raw C-order bytes))``, as flax's
``_ndarray_to_bytes`` writes it, so ``flax.serialization.msgpack_restore``
reads the file back into numpy arrays. Each value takes msgpack's
smallest encoding, as msgpack-python's packer picks it: the bytes equal
flax's for the same tree.
"""

import struct

import torch

EXT_NDARRAY = 1                 # flax's _MsgpackExtType.ndarray
MAX_CHUNK_SIZE = 2 ** 30        # flax chunks larger leaves; this does not

_DTYPE_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
}


def to_bytes(tree) -> bytes:
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def _header(out, n, fix_base, fix_max, codes):
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form (``codes``; None where msgpack has no 8-bit form)."""
    if n < fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n < 2 ** 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 2 ** 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(x, out):
    if 0 <= x < 128:
        out.append(x)
    elif -32 <= x < 0:
        out += struct.pack(">b", x)
    elif x >= 0:
        for code, fmt, top in ((0xcc, "B", 2 ** 8), (0xcd, "H", 2 ** 16),
                               (0xce, "I", 2 ** 32), (0xcf, "Q", 2 ** 64)):
            if x < top:
                out += struct.pack(">B" + fmt, code, x)
                return
        raise OverflowError(f"{x} does not fit msgpack's uint64")
    else:
        for code, fmt, low in ((0xd0, "b", -2 ** 7), (0xd1, "h", -2 ** 15),
                               (0xd2, "i", -2 ** 31), (0xd3, "q", -2 ** 63)):
            if x >= low:
                out += struct.pack(">B" + fmt, code, x)
                return
        raise OverflowError(f"{x} does not fit msgpack's int64")


def _pack_ext(code, data, out):
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fixed:
        out += struct.pack(">Bb", fixed[len(data)], code)
    elif len(data) < 2 ** 8:
        out += struct.pack(">BBb", 0xc7, len(data), code)
    elif len(data) < 2 ** 16:
        out += struct.pack(">BHb", 0xc8, len(data), code)
    else:
        out += struct.pack(">BIb", 0xc9, len(data), code)
    out += data


def _tensor_bytes(t: torch.Tensor) -> bytes:
    name = _DTYPE_NAMES.get(t.dtype)
    if name is None:
        raise TypeError(f"no flax dtype name for {t.dtype}")
    if t.numel() * t.element_size() > MAX_CHUNK_SIZE:
        raise ValueError(
            f"a {tuple(t.shape)} {name} leaf exceeds flax's {MAX_CHUNK_SIZE} "
            "byte chunk size; flax writes it in chunks, this encoder does "
            "not")
    raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    payload = bytearray()
    _pack((tuple(t.shape), name, raw.numpy().tobytes()), payload)
    return bytes(payload)


def _pack(obj, out):
    if isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, len(obj), 0, 0, (0xc4, 0xc5, 0xc6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for key in sorted(obj):
            _pack(key, out)
            _pack(obj[key], out)
    elif isinstance(obj, torch.Tensor):
        _pack_ext(EXT_NDARRAY, _tensor_bytes(obj), out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} in msgpack")
