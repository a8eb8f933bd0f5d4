"""Sign+magnitude bit-plane packing for serving (PyTorch port of
``repro.core.packing``).

The bytes are identical to the JAX packer's (``docs/packed_format.md``):

* ``planes``: ``(..., n, K//8, N) uint8`` — magnitude bit-planes of the
  integer code ``q = |Round[(2^n-1) W/s]|``, plane ``b`` holding bit
  ``b`` (LSB first), 8 consecutive K rows per byte, row ``kb*8 + i`` in
  bit ``i``.  K is zero-padded to a multiple of 8; ``k`` records the
  unpadded row count.
* ``sign``: ``(..., K//8, N) uint8`` — packed sign bits (1 = negative).
* ``scale``: float32, ``()`` (per-tensor), ``(1, G)`` with ``N % G == 0``
  (per-output-group row) or ``lead + (1, 1)`` for stacked tensors.

A JAX export therefore loads into the port with a byte copy
(:mod:`repro_torch.bridge`).  Device bytes per weight element:
``(n+1)/8`` against 2 for bf16.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass
class PackedWeight:
    planes: torch.Tensor  # (..., n_bits, K//8, N) uint8
    sign: torch.Tensor  # (..., K//8, N) uint8
    scale: torch.Tensor  # float32: (), (1, G), or lead + (1, 1)
    n_bits: int
    k: int  # unpadded K
    # Bit width of the dequantisation denominator ``2^denom_bits - 1``.
    # None = n_bits (a freshly packed weight).  A truncated view keeps
    # the ORIGINAL denominator and folds the dropped planes' shift into
    # the scale as a power of two (see truncate_packed).
    denom_bits: Optional[int] = None
    # The mesh axes of the trailing (K, N) axes, e.g. ("data", "model")
    # for a col-parallel weight; None = unsharded.  Set by
    # dist.sharding.annotate_packed_specs (or export_packed_sharded); on a
    # mesh the fields then hold this rank's block while ``k`` stays the
    # whole weight's, and kernels.ops.bitserial_matmul_sharded reads it.
    kn_spec: Optional[Tuple] = None

    @property
    def eff_denom_bits(self) -> int:
        return self.n_bits if self.denom_bits is None else self.denom_bits

    def hbm_bytes(self) -> int:
        return int(self.planes.numel() + self.sign.numel() + self.scale.numel() * 4)

    def to(self, device) -> "PackedWeight":
        return dataclasses.replace(
            self, planes=self.planes.to(device), sign=self.sign.to(device),
            scale=self.scale.to(device))


@dataclasses.dataclass
class FloatBlock:
    """A float matrix's block on a mesh: ``w`` is this rank's (..., K/dk,
    N/dn) slice of the whole weight, ``kn_spec`` the mesh axes of its
    trailing (K, N) axes (``dist.sharding.param_spec``'s last two
    entries).  ``models.common.dense_apply`` stitches it as it stitches
    a PackedWeight, with a local ``torch.matmul``.  Made by
    ``dist.elastic.reshard_tree``."""

    w: torch.Tensor
    kn_spec: Tuple

    def to(self, device) -> "FloatBlock":
        return dataclasses.replace(self, w=self.w.to(device))


@dataclasses.dataclass
class RowsBlock:
    """A stacked (L, N) vector's block on a mesh whose rule splits its
    layer axis too (the RG-LRU gate biases ``b_rgate``/``b_igate``, which
    JAX's rules read as a matrix: ``P("data", "model")``): ``w`` is this
    rank's (L/dl, N/dn) block, ``lo`` the first layer it holds, ``spec``
    the two axes.  ``models.transformer.layer_slice`` gives layer b's row
    where this rank holds it (``w`` None elsewhere), and the model adds
    it into the partial product that its N block's reduction sums, so
    the vector is never gathered.  Made by ``dist.elastic.reshard_tree``."""

    w: Optional[torch.Tensor]
    lo: int
    spec: Tuple

    def to(self, device) -> "RowsBlock":
        return self if self.w is None else dataclasses.replace(self, w=self.w.to(device))


def tree_leaves(tree) -> list:
    """Leaves of a nested dict/list/tuple param tree, PackedWeights kept whole."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map_with_path(fn, tree, path: str = ""):
    """Rebuild a nested dict/list tree with ``fn(path, leaf)`` at each leaf;
    paths join dict keys and list indices with "/" as the JAX key paths do."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_to(tree, device):
    """The same param tree with every tensor and PackedWeight on ``device``."""
    return tree_map_with_path(lambda _, leaf: leaf.to(device), tree)


def packed_leaves(tree) -> List[PackedWeight]:
    """All PackedWeight leaves of a param tree."""
    return [x for x in tree_leaves(tree) if isinstance(x, PackedWeight)]


def scale_row(scale: torch.Tensor, n: int) -> torch.Tensor:
    """Expand a 2D PackedWeight's scale to a ``(1, N)`` per-column f32 row.

    Accepts scalar, ``(1, 1)`` and ``(1, G)`` with ``N % G == 0``;
    K-varying scales have no row form and are rejected."""
    s = torch.as_tensor(scale).to(torch.float32)
    if s.ndim == 0:
        return s.reshape(1, 1).expand(1, n)
    if s.ndim != 2 or s.shape[0] != 1:
        raise ValueError(
            f"per-group scale must be scalar or a (1, G) row, got shape {tuple(s.shape)}")
    g = s.shape[1]
    if g == n:
        return s
    if g == 1:
        return s.expand(1, n)
    if n % g:
        raise ValueError(f"scale groups G={g} do not divide N={n}")
    return torch.repeat_interleave(s, n // g, dim=1)


def _pack_bits_axis0(bits: torch.Tensor) -> torch.Tensor:
    """Pack a {0,1} (K, N) tensor (K % 8 == 0) to (K//8, N) bytes, LSB first."""
    k, n = bits.shape
    b = bits.reshape(k // 8, 8, n).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device).reshape(1, 8, 1)
    return torch.sum(b << shifts, dim=1).to(torch.uint8)


def unpack_bits_axis0(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of the packer: (..., K//8, N) bytes -> (..., K, N) {0,1} uint8."""
    *lead, kb, n = packed.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device).reshape(8, 1)
    bits = (packed[..., :, None, :] >> shifts) & 1
    return bits.reshape(*lead, kb * 8, n)[..., :k, :]


def _check_scale(scale: torch.Tensor, n: int) -> None:
    if scale.ndim == 0:
        return
    if scale.ndim != 2 or scale.shape[0] != 1 or (scale.shape[1] > 1 and n % scale.shape[1]):
        raise ValueError(
            f"scale must be scalar or a (1, G) row with N % G == 0; "
            f"got shape {tuple(scale.shape)} for N={n}")


def pack_quantized(q: torch.Tensor, scale, n_bits: int) -> PackedWeight:
    """Pack a signed integer code matrix ``q`` (K, N), |q| < 2^n_bits."""
    if q.ndim != 2:
        raise ValueError(f"pack_quantized expects a 2D (K, N) matrix, got {tuple(q.shape)}")
    k, n = q.shape
    scale = torch.as_tensor(scale, device=q.device)
    _check_scale(scale, n)
    pad = (-k) % 8
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
    mag = torch.abs(q).to(torch.int64)
    n_bits = max(n_bits, 1)
    planes = torch.stack([_pack_bits_axis0((mag >> b) & 1) for b in range(n_bits)])
    sign = _pack_bits_axis0((q < 0).to(torch.int32))
    return PackedWeight(planes=planes, sign=sign, scale=scale, n_bits=n_bits, k=k)


def unpack_to_float(pw: PackedWeight, dtype=torch.float32) -> torch.Tensor:
    """Dequantise back to float; handles stacked weights and every
    canonical scale form."""
    k = pw.k
    mag = sum(
        unpack_bits_axis0(pw.planes[..., b, :, :], k).to(torch.int32) * (2**b)
        for b in range(pw.n_bits)
    )
    sgn = 1 - 2 * unpack_bits_axis0(pw.sign, k).to(torch.int32)
    denom = 2.0**pw.eff_denom_bits - 1.0
    s = pw.scale.to(dtype)
    n = mag.shape[-1]
    if s.ndim and s.shape[-1] not in (1, n):
        s = torch.repeat_interleave(s, n // s.shape[-1], dim=-1)
    return (sgn * mag).to(dtype) * (s / denom)


def truncate_packed(pw: PackedWeight, k: int) -> PackedWeight:
    """Keep the ``k`` most significant magnitude planes.

    ``W_trunc = sign * [scale * 2^(n-k)] * q_k / (2^n - 1)``: the fold is
    a power of two and the original denominator rides in
    ``denom_bits``, so this view is bitwise identical to the kernels'
    runtime ``active_planes=k``.  The planes are a view of the same
    bytes; each layer's slice of a stacked weight stays contiguous.
    ``k >= n_bits`` returns ``pw`` unchanged."""
    if k < 1:
        raise ValueError(f"need k >= 1 active planes, got {k}")
    n = pw.n_bits
    if k >= n:
        return pw
    return dataclasses.replace(
        pw,
        planes=pw.planes[..., n - k:, :, :],
        scale=pw.scale * float(2 ** (n - k)),
        n_bits=k,
        denom_bits=pw.eff_denom_bits,
    )


def pack_from_float(w: torch.Tensor, n_bits: int, group_cols: int | None = None) -> PackedWeight:
    """One-shot float -> packed path; ``group_cols=G`` quantises with G
    per-output-column-group scales, ``None`` with one per-tensor scale."""
    w = w.to(torch.float32)
    levels = 2**n_bits - 1
    if group_cols:
        k, n = w.shape
        if n % group_cols:
            raise ValueError(f"group_cols={group_cols} does not divide N={n}")
        s = torch.amax(torch.abs(w.reshape(k, group_cols, n // group_cols)), dim=(0, 2))
        s = torch.where(s == 0, torch.ones_like(s), s).reshape(1, group_cols)
        s_cols = torch.repeat_interleave(s, n // group_cols, dim=1)
        q = torch.round(w / s_cols * levels).to(torch.int32)
        return pack_quantized(q, s, n_bits)
    s = torch.amax(torch.abs(w))
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.round(w / s * levels).to(torch.int32)
    return pack_quantized(q, s, n_bits)


def stack_packed(packs: List[PackedWeight], lead: Tuple[int, ...]) -> PackedWeight:
    """Stack per-slice packed weights of one shape into the ``lead +``
    layout, with per-slice scales as ``lead + (1, 1)``."""
    p0 = packs[0]
    return PackedWeight(
        planes=torch.stack([p.planes for p in packs]).reshape(lead + tuple(p0.planes.shape)),
        sign=torch.stack([p.sign for p in packs]).reshape(lead + tuple(p0.sign.shape)),
        scale=torch.stack([p.scale for p in packs]).reshape(lead + (1, 1)),
        n_bits=p0.n_bits,
        k=p0.k,
        kn_spec=p0.kn_spec,
    )


def pack_stacked_from_float(w: torch.Tensor, n_bits: int) -> PackedWeight:
    """Pack a stacked weight (L..., K, N) slice by slice: per-slice
    scale and codes, shared n_bits, leading dims on every field."""
    if w.ndim == 2:
        return pack_from_float(w, n_bits)
    lead = tuple(w.shape[:-2])
    K, N = w.shape[-2:]
    flat = w.reshape((-1, K, N))
    return stack_packed([pack_from_float(flat[i], n_bits) for i in range(flat.shape[0])], lead)


PACKABLE_SUFFIXES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


# The recurrent mixers' matrices (``models.ssm``, ``models.rglru``): float,
# never packable (JAX's PACKABLE_SUFFIXES leaves them out), and read at every
# step of the model.
RECURRENT_MATRICES = frozenset({"in_proj", "out_proj", "w_x", "w_gate_branch", "w_rgate",
                                "w_igate", "w_out"})

# The float matrices that serving holds in the compute dtype, by leaf name:
# the embedding, every packable projection left unpacked (the MoE experts,
# never packed, and any projection too small to pack) and the recurrent
# mixers' matrices.  The model casts each at every use (``x @ w.to(x.dtype)``,
# as JAX does), so one cast up front gives the same bits.  Norm scales, the
# MoE router and the recurrent mixers' vectors and conv weights (decode
# convolves in f32) stay f32.
SERVED_IN_COMPUTE_DTYPE = frozenset(PACKABLE_SUFFIXES) | {"embed"} | RECURRENT_MATRICES


def serving_cast(name: str, leaf, dtype: torch.dtype):
    """``leaf`` as serving holds it: a float matrix named in
    :data:`SERVED_IN_COMPUTE_DTYPE` cast to ``dtype``, anything else (a
    PackedWeight, a norm scale, the router) unchanged."""
    served = name.rsplit("/", 1)[-1] in SERVED_IN_COMPUTE_DTYPE
    if isinstance(leaf, torch.Tensor) and served:
        return leaf.to(dtype)
    if isinstance(leaf, FloatBlock) and served:
        return dataclasses.replace(leaf, w=leaf.w.to(dtype))
    return leaf


def packable(name: str, shape) -> bool:
    leaf = name.lower().rsplit("/", 1)[-1]
    return (
        leaf in PACKABLE_SUFFIXES
        and len(shape) >= 2
        and shape[-2] % 8 == 0
        and min(shape[-2:]) >= 64
        and "/moe/" not in name.lower()
    )


def abstract_packed(shape, n_bits: int) -> PackedWeight:
    """A meta-device twin of :func:`pack_stacked_from_float` for a weight
    of ``shape`` (lead..., K, N): the fields' shapes and dtypes, no data
    (the dry run's)."""
    lead, (K, N) = tuple(shape[:-2]), tuple(shape[-2:])
    K8 = (K + 7) // 8

    def meta(s, dtype):
        return torch.empty(s, dtype=dtype, device="meta")

    return PackedWeight(
        planes=meta(lead + (n_bits, K8, N), torch.uint8),
        sign=meta(lead + (K8, N), torch.uint8),
        scale=meta(lead + (1, 1) if lead else (), torch.float32),
        n_bits=n_bits,
        k=K,
    )


def pack_model_params(params, n_bits: int, abstract: bool = False):
    """Replace packable dense weights in a param tree by PackedWeights
    (``abstract``: by :func:`abstract_packed` meta twins, for the dry run).

    Leaf names are the JAX key paths (``blocks/p0/mixer/wq``), so the
    same leaves pack as in ``repro.core.packing.pack_model_params``."""
    def pack(name, leaf):
        if isinstance(leaf, torch.Tensor) and packable(name, leaf.shape):
            return abstract_packed(leaf.shape, n_bits) if abstract \
                else pack_stacked_from_float(leaf, n_bits)
        return leaf

    return tree_map_with_path(pack, params)
