"""BFieldCodec: canonical serialization of values as base-field element lists.

A copy of ``twenty_first_tpu/math/bfield_codec.py`` (importing that package
would import JAX), held against it by ``tests/test_torch_bfield_codec.py``;
host code over the port's scalar types (``Polynomial``, ``Digest``).

Mirrors twenty-first/src/math/bfield_codec.rs and the derive macro
bfieldcodec_derive/src/lib.rs. Because Python lacks Rust's static types, the
codec is driven by explicit *type descriptors* (`U64`, `Vec_(DIGEST)`, ...).
The derive macro's job is covered by the `bfield_codec` class decorator,
which generates encode/decode from a declared field list using the derive's
exact wire rules:

  * fields are encoded in REVERSE declaration order (lib.rs:197);
  * every dynamically-sized field is preceded by a 1-word length indicator;
  * `decode` must consume the sequence exactly;
  * Vec is length-prefixed by item count; items each get a length prefix iff
    the item type is dynamically sized (bfield_codec.rs:363-544);
  * enums encode a discriminant word followed by the variant's fields.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..errors import BFieldCodecError
from .b_field_element import BFieldElement, bfe
from .x_field_element import XFieldElement


class CodecType:
    """A wire-type descriptor."""

    def static_length(self) -> Optional[int]:
        raise NotImplementedError

    def encode(self, value) -> list[BFieldElement]:
        raise NotImplementedError

    def decode(self, sequence: Sequence[BFieldElement]):
        """Decode, consuming the sequence exactly."""
        raise NotImplementedError


class _Bfe(CodecType):
    def static_length(self):
        return 1

    def encode(self, value):
        return [bfe(value)]

    def decode(self, sequence):
        if len(sequence) == 0:
            raise BFieldCodecError("empty sequence")
        if len(sequence) > 1:
            raise BFieldCodecError("sequence too long")
        return sequence[0]


class _Xfe(CodecType):
    def static_length(self):
        return 3

    def encode(self, value):
        return list(value.coefficients)

    def decode(self, sequence):
        if len(sequence) < 3:
            raise BFieldCodecError("sequence too short")
        if len(sequence) > 3:
            raise BFieldCodecError("sequence too long")
        return XFieldElement(tuple(sequence))


class _Digest(CodecType):
    def static_length(self):
        return 5

    def encode(self, value):
        return list(value.values())

    def decode(self, sequence):
        from ..tip5.digest import Digest

        if len(sequence) < 5:
            raise BFieldCodecError("sequence too short")
        if len(sequence) > 5:
            raise BFieldCodecError("sequence too long")
        return Digest(tuple(sequence))


class _Uint(CodecType):
    """Unsigned ints: 1 word (range-checked) for <= 32 bits; 32-bit
    little-endian chunks for 64/128 bits."""

    def __init__(self, bits: int):
        self.bits = bits
        self.words = 1 if bits <= 32 else bits // 32

    def static_length(self):
        return self.words

    def encode(self, value):
        value = int(value)
        if value < 0 or value >= (1 << self.bits):
            raise BFieldCodecError(f"u{self.bits} out of range: {value}")
        if self.words == 1:
            return [bfe(value)]
        return [
            bfe((value >> (32 * i)) & 0xFFFFFFFF) for i in range(self.words)
        ]

    def decode(self, sequence):
        if len(sequence) == 0:
            raise BFieldCodecError("empty sequence")
        if len(sequence) < self.words:
            raise BFieldCodecError("sequence too short")
        if len(sequence) > self.words:
            raise BFieldCodecError("sequence too long")
        if self.words == 1:
            v = sequence[0].value()
            if v >= (1 << self.bits):
                raise BFieldCodecError("element out of range")
            return v
        acc = 0
        for i, s in enumerate(sequence):
            v = s.value()
            if v > 0xFFFFFFFF:
                raise BFieldCodecError("element out of range")
            acc |= v << (32 * i)
        return acc


class _Int(CodecType):
    """Signed ints: bit-cast to the unsigned twin (bfield_codec.rs:140-164)."""

    def __init__(self, bits: int):
        self.bits = bits
        self.unsigned = _Uint(bits)

    def static_length(self):
        return self.unsigned.static_length()

    def encode(self, value):
        value = int(value)
        half = 1 << (self.bits - 1)
        if value < -half or value >= half:
            raise BFieldCodecError(f"i{self.bits} out of range: {value}")
        return self.unsigned.encode(value & ((1 << self.bits) - 1))

    def decode(self, sequence):
        v = self.unsigned.decode(sequence)
        half = 1 << (self.bits - 1)
        return v - (1 << self.bits) if v >= half else v


class _Bool(CodecType):
    def static_length(self):
        return 1

    def encode(self, value):
        return [bfe(1 if value else 0)]

    def decode(self, sequence):
        if len(sequence) == 0:
            raise BFieldCodecError("empty sequence")
        if len(sequence) > 1:
            raise BFieldCodecError("sequence too long")
        v = sequence[0].value()
        if v > 1:
            raise BFieldCodecError("element out of range")
        return bool(v)


class Vec_(CodecType):
    """Vec<T>: item-count prefix + items (each length-prefixed iff dynamic)."""

    def __init__(self, item: CodecType):
        self.item = item

    def static_length(self):
        return None

    def encode(self, value):
        out = [bfe(len(value))]
        out.extend(_encode_list(self.item, value))
        return out

    def decode(self, sequence):
        if len(sequence) == 0:
            raise BFieldCodecError("empty sequence")
        n = _as_length(sequence[0])
        return _decode_list(self.item, n, sequence[1:])


class Arr(CodecType):
    """[T; N]: items only, no count prefix."""

    def __init__(self, item: CodecType, n: int):
        self.item = item
        self.n = n

    def static_length(self):
        s = self.item.static_length()
        return None if s is None else s * self.n

    def encode(self, value):
        if len(value) != self.n:
            raise BFieldCodecError(f"array needs {self.n} items")
        return _encode_list(self.item, value)

    def decode(self, sequence):
        if self.n > 0 and len(sequence) == 0:
            raise BFieldCodecError("empty sequence")
        return _decode_list(self.item, self.n, sequence)


class Opt(CodecType):
    """Option<T>: 1-word tag + payload."""

    def __init__(self, item: CodecType):
        self.item = item

    def static_length(self):
        return None

    def encode(self, value):
        if value is None:
            return [bfe(0)]
        return [bfe(1)] + self.item.encode(value)

    def decode(self, sequence):
        if len(sequence) == 0:
            raise BFieldCodecError("empty sequence")
        tag = sequence[0].value()
        if tag > 1:
            raise BFieldCodecError("element out of range")
        rest = sequence[1:]
        if tag == 0:
            if rest:
                raise BFieldCodecError("sequence too long")
            return None
        return self.item.decode(rest)


class Tup(CodecType):
    """Tuples: fields in REVERSE declaration order, dynamic fields
    length-prefixed (bfield_codec.rs:241-331)."""

    def __init__(self, *items: CodecType):
        self.items = items

    def static_length(self):
        total = 0
        for it in self.items:
            s = it.static_length()
            if s is None:
                return None
            total += s
        return total

    def encode(self, value):
        if len(value) != len(self.items):
            raise BFieldCodecError("tuple arity mismatch")
        out = []
        for it, v in zip(reversed(self.items), reversed(list(value))):
            enc = it.encode(v)
            if it.static_length() is None:
                out.append(bfe(len(enc)))
            out.extend(enc)
        return out

    def decode(self, sequence):
        sequence = list(sequence)
        decoded_rev = []
        for it in reversed(self.items):
            it_static = it.static_length()
            if it_static is None:
                if len(sequence) == 0:
                    raise BFieldCodecError("missing length indicator")
                length = _as_length(sequence[0])
                sequence = sequence[1:]
            else:
                length = it_static
            if len(sequence) < length:
                raise BFieldCodecError("sequence too short")
            decoded_rev.append(it.decode(sequence[:length]))
            sequence = sequence[length:]
        if sequence:
            raise BFieldCodecError("sequence too long")
        return tuple(reversed(decoded_rev))


class PolyCodec(CodecType):
    """Polynomial: total-length prefix + Vec of coefficients; trailing-zero
    encodings rejected (bfield_codec.rs:411-472)."""

    def __init__(self, item: CodecType):
        self.item = item

    def static_length(self):
        return None

    def encode(self, value):
        deg = value.degree()
        coeffs = value.coefficients[: deg + 1]
        inner = Vec_(self.item).encode(coeffs)
        return [bfe(len(inner))] + inner

    def decode(self, sequence):
        from .polynomial import Polynomial

        if len(sequence) == 0:
            raise BFieldCodecError("empty sequence")
        indicated = _as_length(sequence[0]) + 1
        if len(sequence) < indicated:
            raise BFieldCodecError("sequence too short")
        if len(sequence) > indicated:
            raise BFieldCodecError("sequence too long")
        coeffs = Vec_(self.item).decode(sequence[1:])
        if coeffs and coeffs[-1].is_zero():
            raise BFieldCodecError("trailing zeros in polynomial-encoding")
        return Polynomial(coeffs)


class ObjCodec(CodecType):
    """Descriptor for a @bfield_codec-decorated class (or any class with
    encode()/decode()/static_length())."""

    def __init__(self, cls):
        self.cls = cls

    def static_length(self):
        return self.cls.static_length()

    def encode(self, value):
        return value.encode()

    def decode(self, sequence):
        return self.cls.decode(sequence)


# Canonical descriptor instances
BFE = _Bfe()
XFE = _Xfe()
DIGEST = _Digest()
BOOL = _Bool()
U8 = _Uint(8)
U16 = _Uint(16)
U32 = _Uint(32)
U64 = _Uint(64)
U128 = _Uint(128)
I8 = _Int(8)
I16 = _Int(16)
I32 = _Int(32)
I64 = _Int(64)
I128 = _Int(128)


def _as_length(element: BFieldElement) -> int:
    v = element.value()
    if v > (1 << 32):
        raise BFieldCodecError("invalid length indicator")
    return v


def _encode_list(item: CodecType, values) -> list[BFieldElement]:
    out = []
    dynamic = item.static_length() is None
    for v in values:
        enc = item.encode(v)
        if dynamic:
            out.append(bfe(len(enc)))
        out.extend(enc)
    return out


def _decode_list(item: CodecType, n: int, sequence):
    static = item.static_length()
    out = []
    if static is not None:
        total = n * static
        if len(sequence) < total:
            raise BFieldCodecError("sequence too short")
        if len(sequence) > total:
            raise BFieldCodecError("sequence too long")
        for i in range(n):
            out.append(item.decode(sequence[i * static: (i + 1) * static]))
        return out
    idx = 0
    for _ in range(n):
        if idx >= len(sequence):
            raise BFieldCodecError("missing length indicator")
        length = _as_length(sequence[idx])
        idx += 1
        if len(sequence) < idx + length:
            raise BFieldCodecError("sequence too short")
        out.append(item.decode(sequence[idx: idx + length]))
        idx += length
    if idx != len(sequence):
        raise BFieldCodecError("sequence too long")
    return out


# ---------------------------------------------------------------------------
# Derive-macro equivalent: class decorator
# ---------------------------------------------------------------------------


def bfield_codec(fields: Sequence[tuple] = (), ignore: Sequence[str] = (),
                 variants: Optional[Sequence[tuple]] = None):
    """Generate BFieldCodec methods for a class.

    Structs: `fields` is [(name, CodecType), ...] in declaration order; wire
    order is reversed, dynamic fields are length-prefixed (matching
    bfieldcodec_derive). `ignore`d fields are skipped on encode and
    default-constructed on decode (must have class-level defaults).

    Enums: `variants` is [(variant_name, [(field, CodecType), ...]), ...];
    instances must expose `.variant` (name) and the variant's fields as
    attributes. Encodes discriminant + reversed fields.
    """

    def wrap(cls):
        if variants is not None:
            return _wrap_enum(cls, list(variants))
        return _wrap_struct(cls, list(fields), list(ignore))

    return wrap


def _encode_fields_reversed(obj, field_list) -> list[BFieldElement]:
    out = []
    for name, ftype in reversed(field_list):
        enc = ftype.encode(getattr(obj, name))
        if ftype.static_length() is None:
            out.append(bfe(len(enc)))
        out.extend(enc)
    return out


def _decode_fields_reversed(field_list, sequence) -> dict:
    values = {}
    for name, ftype in reversed(field_list):
        f_static = ftype.static_length()
        if f_static is None:
            if len(sequence) == 0:
                raise BFieldCodecError(f"sequence empty for field {name}")
            length = _as_length(sequence[0])
            sequence = sequence[1:]
        else:
            length = f_static
        if len(sequence) < length:
            raise BFieldCodecError(f"sequence too short for field {name}")
        values[name] = ftype.decode(sequence[:length])
        sequence = sequence[length:]
    if sequence:
        raise BFieldCodecError("sequence too long")
    return values


def _wrap_struct(cls, field_list, ignored):
    # spec validation at decoration time — the analogue of the derive
    # macro's compile errors (twenty-first/trybuild/*.rs): unknown or
    # duplicated attributes must not silently produce a broken codec
    names = [name for name, _ in field_list]
    if len(set(names)) != len(names):
        raise BFieldCodecError(f"duplicate codec field in {cls.__name__}")
    dup_ignore = [n for n in ignored if ignored.count(n) > 1]
    if dup_ignore:
        raise BFieldCodecError(
            f"field {dup_ignore[0]!r} ignored more than once "
            f"(trybuild/multiple_field_attributes.rs analogue)")
    both = set(names) & set(ignored)
    if both:
        raise BFieldCodecError(
            f"field {both.pop()!r} is both encoded and ignored")
    for name, ftype in field_list:
        if not isinstance(ftype, CodecType):
            raise BFieldCodecError(
                f"field {name!r} has a non-codec type "
                f"(trybuild/incorrect_field_attribute.rs analogue)")
    def encode(self) -> list[BFieldElement]:
        return _encode_fields_reversed(self, field_list)

    @classmethod
    def decode(klass, sequence):
        values = _decode_fields_reversed(field_list, list(sequence))
        return klass(**values)

    @staticmethod
    def static_length() -> Optional[int]:
        total = 0
        for _, ftype in field_list:
            s = ftype.static_length()
            if s is None:
                return None
            total += s
        return total

    cls.encode = encode
    cls.decode = decode
    cls.static_length = static_length
    cls.__codec_fields__ = field_list
    cls.__codec_ignored__ = ignored
    return cls


def _wrap_enum(cls, variant_list):
    names = [v[0] for v in variant_list]
    if len(set(names)) != len(names):
        raise BFieldCodecError(f"duplicate enum variant in {cls.__name__}")
    for vname, vfields in variant_list:
        for fname, ftype in vfields:
            if not isinstance(ftype, CodecType):
                raise BFieldCodecError(
                    f"variant {vname!r} field {fname!r} has a "
                    f"non-codec type")

    def encode(self) -> list[BFieldElement]:
        discriminant = names.index(self.variant)
        out = [bfe(discriminant)]
        out.extend(_encode_fields_reversed(self, variant_list[discriminant][1]))
        return out

    @classmethod
    def decode(klass, sequence):
        sequence = list(sequence)
        if not sequence:
            raise BFieldCodecError("empty sequence")
        discriminant = sequence[0].value()
        if discriminant >= len(names):
            raise BFieldCodecError(f"invalid discriminant {discriminant}")
        values = _decode_fields_reversed(variant_list[discriminant][1],
                                         sequence[1:])
        return klass(variant=names[discriminant], **values)

    @staticmethod
    def static_length() -> Optional[int]:
        # Static only for a single fieldless variant (derive lib.rs:733-807).
        if len(variant_list) == 1 and not variant_list[0][1]:
            return 1
        return None

    cls.encode = encode
    cls.decode = decode
    cls.static_length = static_length
    cls.__codec_variants__ = variant_list
    cls.bfield_codec_discriminant = property(
        lambda self: names.index(self.variant)
    )
    return cls


# ---------------------------------------------------------------------------
# Generic entry points
# ---------------------------------------------------------------------------


def descriptor_for(value) -> CodecType:
    from .polynomial import Polynomial
    from ..tip5.digest import Digest

    if isinstance(value, BFieldElement):
        return BFE
    if isinstance(value, XFieldElement):
        return XFE
    if isinstance(value, Digest):
        return DIGEST
    if isinstance(value, bool):
        return BOOL
    if isinstance(value, int):
        return U64
    if isinstance(value, Polynomial):
        item = XFE if value.coefficients and isinstance(
            value.coefficients[0], XFieldElement) else BFE
        return PolyCodec(item)
    if isinstance(value, (list, tuple)) and value:
        return Vec_(descriptor_for(value[0]))
    if hasattr(value, "encode"):
        return ObjCodec(type(value))
    raise BFieldCodecError(f"no codec for {type(value)}")


def encode(value) -> list[BFieldElement]:
    """Encode a value, inferring its descriptor (lists assume homogeneous
    items; ints encode as u64)."""
    return descriptor_for(value).encode(value)


def decode(spec, sequence):
    """Decode with an explicit descriptor or decorated class."""
    if isinstance(spec, CodecType):
        return spec.decode(list(sequence))
    return spec.decode(list(sequence))
