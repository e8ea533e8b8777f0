"""Kernels K1 and K3: packed low-bit matmuls with one scale row (G == 1:
BitNet's per-tensor scale, w_fp's per-column scales and zero points at
group_size -1, the int8 head) and the activations quantized to int8 per
row, at bits 1 to 4 and 8 (bits 3: a 2-bit lo plane and a 1-bit hi plane).

Both replace ``tmac_tpu/ops/pallas/qgemm_kernel.py::_make_kernel`` on the
two routes that ``qgemm_pallas(act="fused")`` takes for one scale row
(``ops.qgemm.route``): K1, for N < 64 rows of x, its
``fused_quant=True, int_acc=True`` form, as CUDA C++ for Hopper in
``csrc/qgemm_fused.cu`` (the prologue) and ``csrc/decode_matmul.cuh``
(the matmul K1 shares with K4: a programmatic dependent launch after the
prologue, K split over a thread-block cluster by ``decode_plan``); K3,
from 64 rows, its ``single_dot`` form (at bits 3 its chunk loop with int32
sums: the same exact dot) after the reference's XLA prologue,
in ``csrc/qgemm_large.cu`` on K1's prologue (wgmma s8 on TMA-fed,
producer-unpacked shared memory; the token tile and a split of K over a
cluster picked by ``large_plan``).
Each source says what bounds its kernel on the card (device-memory bytes
at decode, the tensor cores at prefill) and how its design answers it.

``qgemm_fused`` (K1) and ``qgemm_large_int`` (K3) are the wrappers: a CPU
tensor goes to the plain PyTorch version ``qgemm_fused_plain`` (which
takes the epilogue of the route for N), a CUDA tensor to the kernel, which
either launches or raises.  Each wrapper's ``launches`` counts calls that
launched its kernel (the quantization prologue and the matmul together).

``qgemm_int8_x`` is the external-int8 form (E1: ``qgemm_pallas`` with int8
x and one scale row, any ``act`` but "fused"; the reference's ``int_acc``
branch with no prologue): the caller's codes, the bare code sum, no
activation scale and the epilogue fma(acc, scale, -(xsum * sub)) that the
reference compiles on both routes.  Below LARGE_N rows K1's matmul in its
EXT instance (``launch_decode`` with xs None), from LARGE_N rows K3's
(whose epilogue is that one times xs, so xs = 1) on the codes put in K3's
order (``dp4a_order``, a torch copy that the tools' timings include); its
plain version is ``int8_x_plain``.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from tmac_tpu_torch.ops.qgemm import LARGE_N, QuantizedTensor, pad_x_for, unpack_codes
from tmac_tpu_torch.utils import cdiv, fma_f32, round_up

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_supported(qt: QuantizedTensor, glu: bool, norm, residual) -> None:
    if qt.bits not in (1, 2, 3, 4, 8):
        raise ValueError(f"K1 takes bits 1 to 4 and 8, not {qt.bits}")
    if (qt.bits == 3) != (qt.packed_hi is not None):
        raise ValueError("K1 takes a hi plane at bits 3 and at bits 3 only")
    if qt.scales.shape[0] != 1 or qt.k_shards != 1:
        raise ValueError("K1 takes one scale row (G == 1) and k_shards == 1")
    if glu and (norm is not None or qt.kdim_padded != qt.kdim):
        raise ValueError("the glu fold needs no norm and an unpadded K")
    if residual is not None and (qt.mdim_padded != qt.mdim
                                 or qt.m_segments is not None):
        raise ValueError("the residual fold needs an unpadded, unfused M")
    if residual is not None and residual.dtype != torch.bfloat16:
        raise ValueError(f"the residual fold takes bf16, not {residual.dtype}")


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path, and what the kernel is held to)
# ---------------------------------------------------------------------------

# XLA's CPU backend adds a row longer than this in windows of this many
# values (kSumWindow in csrc/act_prologue.cuh)
SUM_WINDOW = 32


def row_sum_xla_order(v: torch.Tensor) -> torch.Tensor:
    """Row sums (N, 1) of v (N, n) in the order the JAX reference compiles
    to on the CPU, each addition rounded on its own: a row longer than 32
    is zero-padded evenly on both sides to a multiple of 32, each window
    of 32 is summed from left to right, and the window sums are reduced
    the same way until 32 or fewer remain, which are added from left to
    right.  The prologue kernels add in this order too."""
    W = SUM_WINDOW
    while v.shape[1] > W:
        pad = -v.shape[1] % W
        v = torch.nn.functional.pad(v, (pad // 2, pad - pad // 2))
        v = v.reshape(v.shape[0], -1, W)
        s = torch.zeros_like(v[:, :, 0])
        for j in range(W):
            s = s + v[:, :, j]
        v = s
    s = torch.zeros_like(v[:, :1])
    for j in range(v.shape[1]):
        s = s + v[:, j:j + 1]
    return s


def prologue_values(x: torch.Tensor, K: int, Kp: int, norm=None,
                    glu: bool = False) -> torch.Tensor:
    """x (N, K) or (N, 2K) -> the f32 values (N, Kp) that are quantized:
    silu(g) * u with glu, then rms_norm with norm (variance over the
    logical K), zero past K.  Written as the prologue kernels compute them
    (IEEE exp, sqrt and division, the row sum in the reference's order),
    so that kernel and plain version agree bit for bit."""
    xf = x.to(torch.bfloat16).float()
    if glu:
        g = xf[:, :K]
        xf = g * (1.0 / (1.0 + torch.exp(-g))) * xf[:, K:]
    xf = torch.nn.functional.pad(xf, (0, Kp - K))
    if norm is not None:
        xf = rms_norm_values(xf, norm[0], norm[1], K)
    return xf


def rms_norm_values(xf: torch.Tensor, w: torch.Tensor, eps: float,
                    K: int) -> torch.Tensor:
    """rms_norm of f32 rows xf (N, Kp), zero past the logical K, with the
    weight w (K,): (xf * (1 / sqrt(var + eps))) * w, the variance over K
    with the row sum in the reference's order (the prologue kernels' and
    K10's steps)."""
    var = row_sum_xla_order(xf * xf) * (1.0 / K)
    xf = xf * (1.0 / torch.sqrt(var + eps))
    return xf * torch.nn.functional.pad(w.float(), (0, xf.shape[1] - K))


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """The int8 scale of an absmax, as XLA compiles the JAX package's
    `max(amax, 1e-20) / 127.0`: times the f32 reciprocal of 127."""
    return torch.clamp_min(amax, 1e-20) * torch.full_like(amax, 1.0 / 127.0)


def act_quant_plain(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                    glu: bool = False, large_n: bool = False):
    """The prologue: x (N, K) or (N, 2K) -> (codes int8 (N, Kp) in natural
    k order, xs (N,) f32, xsum (N,) f32), as the TPU kernel's step 0.
    xsum is the code sum times xs, or the bare code sum for the large-N
    epilogue."""
    xf = prologue_values(x, qt.kdim, qt.kdim_padded, norm, glu)
    xs = act_scale(xf.abs().amax(1, keepdim=True))
    # the codes take a true division, by a tensor: on CUDA PyTorch turns
    # division by a Python scalar into a reciprocal multiply
    q = torch.clamp(torch.round(xf / xs), -127, 127)
    xsum = q.sum(1, keepdim=True)
    if not large_n:
        xsum = xsum * xs
    return q.to(torch.int8), xs[:, 0], xsum[:, 0]


def int_dot_plain(codes: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Exact int32 codes (N, Kp) @ weight codes (Kp, Mp): a float64 matmul
    (exact: |sum| <= 127 * 255 * Kp < 2^53) that runs on CPU and CUDA."""
    w = unpack_codes(qt)
    return (codes.double() @ w.double()).to(torch.int32)


def dp4a_order(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Natural-order codes (N, Kp) -> the order K3's prologue writes: k' =
    F*r + j holds the code of k = r + j*Kp/F, F = decode_fields(bits) the
    slots of a packed row (2 at bits 4, 4 at bits 2, 8 at bits 1 and 3, so
    the fields of a packed byte, or at bits 3 the slots of lo rows r and r
    + Kp/8 and hi row r, are F consecutive k'); k' = k at bits 8."""
    F = decode_fields(bits)
    N, Kp = codes.shape
    return codes.reshape(N, F, Kp // F).transpose(1, 2).reshape(N, Kp)


# ---------------------------------------------------------------------------
# The decode matmul's plan (csrc/decode_matmul.cuh), shared by K1 and K4
# ---------------------------------------------------------------------------

DECODE_STRIP = 128        # output columns of a block
DECODE_STAGE_ROWS = 32    # packed rows of a ring stage (K1's unit of the split)
DECODE_STAGES = 8         # the ring's stages (K1, K4; K7 takes 6 or 8)
DECODE_STAGES_B3 = 3      # K1 and K4 at bits 3: stages of 3 planes (12 KB each)
DECODE_MAX_SPLIT = 8      # portable cluster size
DECODE_XBUF = 8 * 32 * 20 * 4   # K4's per-warp exchange buffers
DECODE_SMEM_BUDGET = 112 * 1024   # two blocks an SM
# a block's fixed costs in packed rows streamed, by token rows a block, and
# the cluster sizes the plan takes (7 was never measured); nt = 2 (bits 1
# and 3) is the mean of the two fitted values, not fitted itself
DECODE_FIXED_ROWS = {1: 96, 2: 176, 4: 256}
DECODE_SPLITS = (1, 2, 3, 4, 5, 6, 8)
DECODE_SMEM_LIMIT = 227 * 1024    # a block's shared memory on Hopper
DEFAULT_SMS = 132         # an H100 SXM's SMs: the plan on the CPU
# K7's plan (decode_plan with an expert count), a cost model fitted to K7's
# times at every (cluster size, token rows a block, ring stages) at
# Mixtral-8x7B's expert shapes, 1 and 2 experts, N = 1 and 4, on an H100
# (PERF.md's K7 findings): an SM's shared memory and a block's reserve of
# it; the blocks an SM holds by registers (token rows a block 1, 4; 2, bits
# 1's 8 slots a row, takes nt 4's value unfitted: as many int32 sums); the share of
# the slots clusters of 4 or more blocks fill (a cluster stays inside a
# GPC); the bytes an SM must have in flight to stream at full rate; a
# block's fixed cost in packed rows per group of its fold (the partials'
# exchange, the f32 chain); the extra work a packed row costs per token
# row of a block past the first
SM_SMEM, BLOCK_SMEM_RESERVE = 228 * 1024, 1024
EXPERT_BLOCKS_PER_SM = {1: 3, 2: 2, 4: 2}
WIDE_CLUSTER_FILL = 7 / 8
EXPERT_INFLIGHT_BYTES = 36 * 1024
EXPERT_FIXED_ROWS_PER_GROUP = 12
EXPERT_ROW_COST_PER_TOKEN = 1 / 3
EXPERT_SPLITS, EXPERT_STAGES = (1, 2, 4, 8), (6, 8)


def decode_fields(bits: int) -> int:
    """The slots P of a packed row in the decode matmul: its fields (8 at
    bits 1, 4 at bits 2, 2 at bits 4, 1 at bits 8), and 8 at bits 3, whose
    row r stands for lo plane rows r and r + Kb and hi plane row r
    (decode_units)."""
    return 1 if bits == 8 else 8 if bits == 3 else 8 // bits


def decode_planes(bits: int) -> int:
    """Packed rows of device memory a row of the decode matmul reads: 3 at
    bits 3 (two lo plane rows, one hi plane row), else 1."""
    return 3 if bits == 3 else 1


def decode_units(Kp: int, bits: int, gs: int = 0):
    """The rows Kb, the rows of a unit of the K split (a chunk of gs rows
    for grouped scales, whose slot j holds group j * nchunks + c; a ring
    stage of 32 rows for per-tensor ones) and the unit count.  A row is a
    packed row, except at bits 3: there row r (Kb = Kp / 8) is lo plane
    rows r and r + Kb and hi plane row r, the 8 k = e * Kb + r (slot e: lo
    row r + (e % 2) * Kb, field e // 2; hi bit e), so each hi byte is read
    once, with both lo bytes that share it."""
    Kb = Kp // decode_fields(bits)
    unit = gs or DECODE_STAGE_ROWS
    return Kb, unit, cdiv(Kb, unit)


def decode_stages(bits: int) -> int:
    """The ring's stages of K1 and K4 at bits: DECODE_STAGES, or at bits 3,
    whose stage is 3 planes of 32 rows, DECODE_STAGES_B3."""
    return DECODE_STAGES_B3 if bits == 3 else DECODE_STAGES


def decode_nt(N: int, bits: int) -> int:
    """Token rows a block of the decode matmul: 1 for N = 1, else 4, or 2
    at 8 slots a row (bits 1 and 3), whose int32 sums take 32 registers a
    token row."""
    return 1 if N == 1 else 2 if decode_fields(bits) == 8 else 4


def decode_spans(nunits: int, ksplit: int):
    """The units [u0, u1) block `rank` of a cluster of ksplit takes: u0 =
    rank * nunits // ksplit, contiguous and in rank order (empty when
    ksplit > nunits)."""
    return [(r * nunits // ksplit, (r + 1) * nunits // ksplit) for r in range(ksplit)]


def decode_owner(nunits: int, ksplit: int):
    """For each unit (chunk) c: (the rank that owns it, its index there)."""
    owner = []
    for rank, (u0, u1) in enumerate(decode_spans(nunits, ksplit)):
        owner += [(rank, c - u0) for c in range(u0, u1)]
    return owner


def decode_smem(bits: int, nt: int, grouped: bool, nunits: int, unit: int,
                ksplit: int, G: int, stages=None, acts: int = 0,
                scale_bytes: int = 2, stream: bool = True) -> int:
    """A block's shared memory, as decode_matmul.cuh's Layout sizes it: the
    ring of `stages` stages (decode_stages' by default) of decode_planes
    planes (or the partials it receives for its slice of columns, if
    larger), the codes of its rows, its int32 partials and, grouped, the
    fold's scales and zero points of its slice (scale_bytes each: 2 bf16,
    4 f32) and the tile's xs, xsum.  acts: the activation groups (a partial
    and an xs each) of K4's ags form, or 0 (one a weight group).  Where
    every group's factors would pass DECODE_SMEM_LIMIT the kernel streams
    them in windows through two slots (decode_windows); stream=False sizes
    the block without that."""
    P = decode_fields(bits)
    units = cdiv(nunits, ksplit)
    span = round_up(units * unit, DECODE_STAGE_ROWS)
    slice_ = cdiv(DECODE_STRIP // 8, ksplit) * 8
    recv = ((acts or G) if grouped else ksplit) * nt * slice_ * 4
    ring = (stages or decode_stages(bits)) * DECODE_STAGE_ROWS * DECODE_STRIP \
        * decode_planes(bits)
    total = round_up(max(ring, recv), 16) + round_up(nt * P * span, 16)
    total += (units * P if grouped else 1) * nt * DECODE_STRIP * 4
    if not grouped:
        return total
    rest = round_up(nt * ((acts or G) + G) * 4, 16) + DECODE_XBUF
    fwin, slots = decode_windows(total, rest, G, slice_, scale_bytes) if stream else (G, 1)
    return total + slots * fwin * 2 * slice_ * scale_bytes + rest


def decode_windows(fsc: int, rest: int, G: int, slice_: int, scale_bytes: int):
    """The grouped fold's factor windows (decode_matmul.cuh's Layout): ->
    (groups a window, slots).  Every group's at once, (G, 1), where that
    fits DECODE_SMEM_LIMIT beside the fsc bytes before the factors and the
    rest after them; else windows of equal size in two slots, as few as
    fit (gs 16 with f32 factors at K 14336)."""
    per_group = 2 * slice_ * scale_bytes
    if fsc + G * per_group + rest <= DECODE_SMEM_LIMIT:
        return G, 1
    per_slot = (DECODE_SMEM_LIMIT - fsc - rest) // 2 // per_group
    if per_slot < 1:
        return G, 1
    return cdiv(G, cdiv(G, per_slot)), 2


def decode_plan(N: int, Kp: int, Mp: int, bits: int, gs: int = 0,
                sms: int = DEFAULT_SMS, experts: int = 0, ags: int = 0,
                scale_bytes: int = 2):
    """(ksplit, nt) for the decode matmul from shapes only, so a CUDA graph
    can capture the call: nt token rows a block (decode_nt), and
    the blocks of a cluster along K, no more than the units of the split,
    whichever of DECODE_SPLITS minimises waves x (packed rows a block,
    three a row at bits 3, + a block's fixed costs, DECODE_FIXED_ROWS[nt]),
    20% more for a cluster size that is no power of two: a block's rows
    stream in a time about proportional to their count, and a second,
    part-filled wave of blocks repeats both (an SM holds two blocks, or one whose shared memory
    passes half of it).  The constants were fitted to every ksplit's time
    at the paths' shapes on an H100 (chip_smoke.py --phase
    decode_plan_sweep; PERF.md).  Ties go to the smaller cluster.

    experts (K7, 1 or more routed experts, one grid slice each): -> (ksplit,
    nt, stages), from EXPERT_SPLITS, nt 1 or (N > 1) 4 and EXPERT_STAGES,
    whichever minimises waves x (blocks an SM x packed rows a block / the
    share of the full rate its bytes in flight reach + the fold's fixed
    cost): the waves count every expert's clusters against the slots they
    can fill (an SM holds as many blocks as its shared memory and
    registers allow, clusters of 4 or more fill WIDE_CLUSTER_FILL of
    them), and a block with fewer bytes in flight than
    EXPERT_INFLIGHT_BYTES streams slower.  Raises if no configuration
    fits a block's shared memory.

    ags (K4's ags form): the split's unit and the fold's partials are the
    activation groups of ags packed rows.  scale_bytes: the grouped fold's
    factors, 2 (bf16) or 4 (f32, which stage twice the bytes).  Where no
    cluster size fits a block at decode_nt's token rows (many groups: K
    14336 at gs 32 from 2 rows), K4 takes one token row a block; where none
    fits at one row with every group's factors staged (gs 16 with f32
    factors at K 14336), the plan is the same search over blocks that
    stream their factors (decode_windows)."""
    Kb, unit, nunits = decode_units(Kp, bits, ags or gs)
    grouped, G = gs > 0, Kp // gs if gs else 1
    acts = Kp // ags if ags else 0
    # blocks that stage every group's factors first (every form the plan was
    # fitted to), blocks that stream them only where none of those fits
    for stream in (False, True):
        best = (_expert_plan if experts else _dense_plan)(
            N, Mp, bits, grouped, nunits, unit, G, sms, experts, acts, scale_bytes, stream)
        if best is not None:
            return best[1] if experts else _tuned_split(N, Kp, bits, gs, ags, scale_bytes,
                                                        nunits, best[1], Mp)
    raise ValueError(f"decode matmul: K = {Kp} at N = {N} outgrows a block's "
                     "shared memory")


def _tuned_split(N, Kp, bits, gs, ags, scale_bytes, nunits, plan, Mp):
    """The plan with the tune table's cluster size where the table holds
    one for this card and shape (ops/tune_table.py; read only where the
    file exists) and it fits the plan's token rows."""
    from tmac_tpu_torch.ops import tune_table
    ks = tune_table.lookup_decode(bits, Kp, Mp, N, gs, ags)
    if not ks or ks > nunits or ks not in DECODE_SPLITS:
        return plan
    try:
        check_decode_smem("decode", N, Kp, bits, gs, ks, plan[1], ags=ags,
                          scale_bytes=scale_bytes)
    except ValueError:
        return plan
    return ks, plan[1]


def _expert_plan(N, Mp, bits, grouped, nunits, unit, G, sms, experts, acts, scale_bytes,
                 stream):
    """decode_plan's search for K7: -> (cost, (ksplit, nt, stages)) or None."""
    best = None
    for nt, ksplit, stages in itertools.product(
            (1, decode_nt(N, bits)) if N > 1 else (1,), EXPERT_SPLITS, EXPERT_STAGES):
        smem = decode_smem(bits, nt, grouped, nunits, unit, ksplit, G, stages,
                           scale_bytes=scale_bytes, stream=stream)
        if ksplit > nunits or smem > DECODE_SMEM_LIMIT:
            continue
        per_sm = max(1, min(EXPERT_BLOCKS_PER_SM[nt],
                            SM_SMEM // (smem + BLOCK_SMEM_RESERVE)))
        clusters = (Mp // DECODE_STRIP) * cdiv(N, nt) * experts
        fit = per_sm * sms // ksplit
        if ksplit >= 4:
            fit = int(fit * WIDE_CLUSTER_FILL)
        occupancy = min(per_sm, cdiv(clusters * ksplit, sms))
        rate = min(1.0, occupancy * (stages - 1) * DECODE_STAGE_ROWS * DECODE_STRIP
                   / EXPERT_INFLIGHT_BYTES)
        rows = cdiv(nunits, ksplit) * unit * (1 + EXPERT_ROW_COST_PER_TOKEN * (nt - 1))
        cost = cdiv(clusters, max(fit, 1)) * (occupancy * rows / rate
                                               + EXPERT_FIXED_ROWS_PER_GROUP * G)
        if best is None or cost < best[0]:
            best = (cost, (ksplit, nt, stages))
    return best


def _dense_plan(N, Mp, bits, grouped, nunits, unit, G, sms, experts, acts, scale_bytes,
                stream):
    """decode_plan's search for K1 and K4: -> (cost, (ksplit, nt)) or None."""
    for nt in dict.fromkeys((decode_nt(N, bits), 1)):
        best = None
        clusters = (Mp // DECODE_STRIP) * cdiv(N, nt)
        for ksplit in DECODE_SPLITS:
            smem = decode_smem(bits, nt, grouped, nunits, unit, ksplit, G, acts=acts,
                               scale_bytes=scale_bytes, stream=stream)
            if ksplit > nunits or smem > DECODE_SMEM_LIMIT:
                continue
            per_sm = 2 if smem <= DECODE_SMEM_BUDGET else 1
            waves = cdiv(clusters * ksplit, per_sm * sms)
            cost = waves * (cdiv(nunits, ksplit) * unit * decode_planes(bits)
                            + DECODE_FIXED_ROWS[nt])
            if ksplit & (ksplit - 1):
                cost *= 1.2
            if best is None or cost < best[0]:
                best = (cost, (ksplit, nt))
        if best is not None:
            return best
    return None


def check_decode_smem(kernel: str, N: int, Kp: int, bits: int, gs: int,
                      ksplit: int, nt: int, stages=None, ags: int = 0,
                      scale_bytes: int = 2) -> None:
    """Raise if a forced cluster size leaves a block more shared memory
    than the card has (decode_plan's own never does)."""
    _, unit, nunits = decode_units(Kp, bits, ags or gs)
    need = decode_smem(bits, nt, gs > 0, nunits, unit, ksplit, Kp // gs if gs else 1,
                       stages, Kp // ags if ags else 0, scale_bytes)
    if need > DECODE_SMEM_LIMIT:
        raise ValueError(f"{kernel}: ksplit {ksplit} at N = {N}, K = {Kp} needs "
                         f"{need} bytes of shared memory a block")


def decode_slot_weights(qt: QuantizedTensor, r0: int, r1: int, e: int):
    """What slot e of the decode matmul's rows [r0, r1) (decode_units)
    multiplies in its dp4a, as csrc/decode_matmul.cuh forms it in place:
    -> (weight bytes (r1 - r0, Mp) int64, the shift its flush takes back).
    Bits 8: the signed codes as stored (one slot).  Bits 1, 2, 4: field e of the packed bytes masked in place, i.e. times
    2^(bits * e).  Bits 3: the code lo + 4 * hi of k = e * Kb + r
    assembled at bit t = min(2 * (e // 2), 4) of the byte: field e // 2 of
    lo plane row r + (e % 2) * Kb, shifted right by 2 * (e // 2) - t, and
    bit e of hi plane row r, moved to bit t + 2 (tmac::decode::b3_slot)."""
    if qt.bits == 8:
        return qt.packed[r0:r1].view(torch.int8).long(), 0
    pk = qt.packed.long()
    if qt.bits != 3:
        return pk[r0:r1] & (((1 << qt.bits) - 1) << (qt.bits * e)), qt.bits * e
    Kb, j = qt.kdim_padded // 8, e // 2
    t = min(2 * j, 4)
    lo = pk[r0 + (e % 2) * Kb:r1 + (e % 2) * Kb] >> (2 * j - t)
    hi, hs = qt.packed_hi.long()[r0:r1], t + 2 - e
    hi = hi << hs if hs >= 0 else hi >> -hs
    return (lo & (3 << t)) | (hi & (4 << t)), t


def int_dot_split_plain(codes: torch.Tensor, qt: QuantizedTensor,
                        ksplit: int) -> torch.Tensor:
    """K1's int32 sums as the decode matmul splits them: block `rank` takes
    the rows of its units (decode_units: at bits 3 a row is lo plane rows r
    and r + Kb and hi plane row r), each slot e's weights formed in place
    (decode_slot_weights: times 2^shift) meet the natural-order codes k = e
    * Kb + row, the sum is shifted back, and the blocks' sums are added in
    rank order.  -> (N, Mp) int32, equal to int_dot_plain."""
    bits = qt.bits
    Kb, unit, nunits = decode_units(qt.kdim_padded, bits)
    c = codes.long()
    total = torch.zeros((codes.shape[0], qt.mdim_padded), dtype=torch.long)
    for u0, u1 in decode_spans(nunits, ksplit):
        r0, r1 = u0 * unit, min(u1 * unit, Kb)
        for e in range(decode_fields(bits)):
            w, shift = decode_slot_weights(qt, r0, r1, e)
            total += (c[:, e * Kb + r0:e * Kb + r1] @ w) >> shift
    return total.to(torch.int32)


def qgemm_fused_plain(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                      glu: bool = False, residual=None) -> torch.Tensor:
    """The function K1 (N < LARGE_N) and K3 (from LARGE_N rows) compute, in
    plain PyTorch: (N, M) f32.  The f32 epilogue is the one the reference
    compiles to on its route for N (the headers of csrc/qgemm_fused.cu and
    csrc/qgemm_large.cu), every step rounded as there."""
    _check_supported(qt, glu, norm, residual)
    large = x.shape[0] >= LARGE_N
    codes, xs, xsum = act_quant_plain(x, qt, norm, glu, large)
    acc = int_dot_plain(codes, qt)
    if large:
        return qt.slice_m(large_epilogue_plain(acc, xs, xsum, qt, residual))
    return qt.slice_m(decode_epilogue_plain(acc, xs, xsum, qt, residual))


def decode_epilogue_plain(acc: torch.Tensor, xs: torch.Tensor, xsum: torch.Tensor,
                          qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """K1's f32 epilogue below LARGE_N rows (and K7's per-tensor one) on the
    exact int32 sums acc (N, Mp), xs and the dequantized code sums xsum
    (N,): fma(acc * scale, xs, -(xsum * sub)) (+ residual), each step
    rounded as the reference compiles it.  -> (N, Mp) f32."""
    acc = acc.float()
    scale, xs = qt.scales[0].float().expand_as(acc), xs[:, None].expand_as(acc)
    zero_fold = -(xsum[:, None] * qt.sub[0].float())
    out = fma_f32(acc * scale, xs, zero_fold)
    if residual is not None:
        out = out + residual.float()
    return out


def large_epilogue_plain(acc: torch.Tensor, xs: torch.Tensor, xsum: torch.Tensor,
                         qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """K3's f32 epilogue on the exact int32 sums acc (N, Mp), xs and the
    bare code sums xsum (N,): fma(acc, scale, -(xsum * sub)) * xs, or
    fma(that, xs, residual), each step rounded as the reference's N >= 64
    route compiles it.  -> (N, Mp) f32."""
    acc = acc.float()
    scale, xs = qt.scales[0].float().expand_as(acc), xs[:, None].expand_as(acc)
    out = fma_f32(acc, scale, -(xsum[:, None] * qt.sub[0].float()))
    return out * xs if residual is None else fma_f32(out, xs, residual.float())


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("qgemm_fused")
    lib.tmac_act_quant.argtypes = [
        _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr, _c_float,
        _c_float, _c_int, _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr]
    lib.tmac_act_quant.restype = _c_int
    lib.tmac_decode_qgemm.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr,
        _c_ptr, _c_int, _c_ptr, _c_ptr, _c_int, _c_int, _c_ptr]
    lib.tmac_decode_qgemm.restype = _c_int
    return lib


def require(kernel: str, t: torch.Tensor, what: str, dtype, shape,
            device) -> None:
    """Raise unless t is what `kernel`'s C interface takes."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {what} must be a contiguous {dtype} {tuple(shape)} "
            f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def raise_on(kernel: str, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel} {what} launch failed with CUDA error {err}")


def launch_act_quant(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                     glu: bool = False, large_n: bool = False):
    """Launch K1's prologue (K3's with large_n): -> (codes (N, Kp) int8,
    xs (N,), xsum (N,)); xsum as act_quant_plain gives it.  The codes in
    natural k order for K1's matmul, in K3's order (dp4a_order) for
    K3's."""
    dev = x.device
    N = x.shape[0]
    K, Kp = qt.kdim, qt.kdim_padded
    require("K1", x, "x", torch.bfloat16, (N, 2 * K if glu else K), dev)
    norm_ptr, eps = None, 0.0
    if norm is not None:
        w, eps = norm
        require("K1", w, "norm weight", torch.bfloat16, (K,), dev)
        norm_ptr = w.data_ptr()
    codes = torch.empty((N, Kp), dtype=torch.int8, device=dev)
    xs = torch.empty((N,), dtype=torch.float32, device=dev)
    xsum = torch.empty((N,), dtype=torch.float32, device=dev)
    err = _lib().tmac_act_quant(
        x.data_ptr(), N, x.shape[1], K, Kp, int(glu), norm_ptr, float(eps),
        1.0 / K, qt.bits, int(large_n), int(large_n), codes.data_ptr(), xs.data_ptr(),
        xsum.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on("K1", err, "prologue")
    return codes, xs, xsum


def _check_gemm_args(kernel: str, codes, xs, xsum, qt: QuantizedTensor,
                     residual):
    """Raise unless the prologue's outputs, the weights and the residual
    are what `kernel`'s matmul takes; -> the residual's pointer or None."""
    dev = codes.device
    N, Kp, Mp = codes.shape[0], qt.kdim_padded, qt.mdim_padded
    require(kernel, codes, "codes", torch.int8, (N, Kp), dev)
    if xs is not None:
        require(kernel, xs, "xs", torch.float32, (N,), dev)
    require(kernel, xsum, "xsum", torch.float32, (N,), dev)
    rows = Kp // 4 if qt.bits == 3 else Kp * qt.bits // 8
    require(kernel, qt.packed, "packed", torch.uint8, (rows, Mp), dev)
    if qt.bits == 3:
        require(kernel, qt.packed_hi, "packed_hi", torch.uint8, (Kp // 8, Mp), dev)
    require(kernel, qt.scales, "scales", torch.float32, (1, Mp), dev)
    require(kernel, qt.sub, "sub", torch.float32, (1, Mp), dev)
    if residual is None:
        return None
    require(kernel, residual, "residual", torch.bfloat16, (N, Mp), dev)
    return residual.data_ptr()


def _hi_ptr(qt: QuantizedTensor) -> int:
    """The hi plane's address at bits 3, else 0."""
    return qt.packed_hi.data_ptr() if qt.packed_hi is not None else 0


def _sms(dev) -> int:
    from tmac_tpu_torch.ops.cuda.attention_kernel import sm_count
    return sm_count(dev)


def launch_decode(codes: torch.Tensor, xs, xsum: torch.Tensor,
                  qt: QuantizedTensor, residual=None, ksplit=None) -> torch.Tensor:
    """Launch K1's matmul on its prologue's outputs (large_n off), right
    after the prologue (it starts while the prologue runs): -> (N, Mp)
    f32.  ksplit: the cluster size along K (decode_plan's by default).
    xs None: the external-int8 form's instance (E1: the caller's codes,
    xsum their bare sum, fma(acc, scale, -(xsum * sub)))."""
    res_ptr = _check_gemm_args("K1", codes, xs, xsum, qt, residual)
    N, Kp, Mp = codes.shape[0], qt.kdim_padded, qt.mdim_padded
    if (qt.packed.data_ptr() % 16 or _hi_ptr(qt) % 16 or codes.data_ptr() % 4
            or Mp % DECODE_STRIP):
        raise ValueError("K1: 16-byte aligned packed weights, 4-byte aligned "
                         "codes and Mp % 128 == 0")
    plan, nt = decode_plan(N, Kp, Mp, qt.bits, 0, _sms(codes.device))
    check_decode_smem("K1", N, Kp, qt.bits, 0, ksplit or plan, nt)
    out = torch.empty((N, Mp), dtype=torch.float32, device=codes.device)
    err = _lib().tmac_decode_qgemm(
        codes.data_ptr(), None if xs is None else xs.data_ptr(), xsum.data_ptr(), N, Kp, qt.bits,
        qt.packed.data_ptr(), _hi_ptr(qt), qt.scales.data_ptr(),
        qt.sub.data_ptr(), Mp, res_ptr, out.data_ptr(), ksplit or plan, nt,
        torch.cuda.current_stream(codes.device).cuda_stream)
    raise_on("K1", err, "matmul")
    return out


def _on_device(kernel: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU one (the
    plain version runs); raise on any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on CPU or CUDA tensors, not {x.device}")
    return x.device.type == "cuda"


def qgemm_fused(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                glu: bool = False, residual=None) -> torch.Tensor:
    """K1: x (N, K) [(N, 2K) with glu] @ Wdq -> (N, M) f32 for N < 64
    rows, with the activations quantized per row to int8 inside the kernel.

    norm: (weight (K,), eps) rms_norm before quantization.  glu: x is the
    fused gate_up output and silu(g) * u feeds the matmul.  residual:
    (N, M) added in the epilogue.  CPU tensors take the plain version; CUDA
    tensors take the kernel (x, the norm weight and the residual in bf16).
    From 64 rows the reference takes another route: K3, qgemm_large_int
    (``ops.qgemm.kernel_for`` picks)."""
    _check_supported(qt, glu, norm, residual)
    if x.shape[0] >= LARGE_N:
        raise ValueError(f"K1 takes N < {LARGE_N} rows, not {x.shape[0]}: "
                         "K3 (qgemm_large_int) takes the rest")
    if not _on_device("K1", x):
        return qgemm_fused_plain(x, qt, norm, glu, residual)
    codes, xs, xsum = launch_act_quant(x, qt, norm, glu)
    out = launch_decode(codes, xs, xsum, qt, residual)
    qgemm_fused.launches += 1
    return qt.slice_m(out)


qgemm_fused.launches = 0


# ---------------------------------------------------------------------------
# K3's plan (csrc/qgemm_large.cu, k3_wgmma_kernel)
# ---------------------------------------------------------------------------

LARGE_STEP = 128          # k' of a step (one 128-byte swizzled row of A and B)
# a block's (token rows, columns): (1 x m64, n128), (2 x m64, n128),
# (2 x 2 x m64, n128), and at bits 2 (1 x m64, n256), (2 x m64, n256): the
# wide tiles were fitted to bits 2 alone, and each instance adds to the build
LARGE_TILES = ((64, 128), (128, 128), (256, 128), (64, 256), (128, 256))
LARGE_MAX_SPLIT = 8       # portable cluster size
LARGE_MAX_STAGES = 8
# large_plan's cost model, fitted (least squares on log times) to the
# matmul's time at every tile and cluster size 1-8 on BitNet-3B's prefill
# shapes at N = 64, 256 and 1024 on an H100 (PERF.md, PR 10), in
# microseconds: a step's time by tile (times LARGE_BITS_STEP[bits]: bits 8
# has four times the packed bytes to unpack; bits 1, 3 and 4 take bits 2's
# step, not fitted); a block's fixed time, LARGE_FIXED_US
# plus LARGE_AREA_US times its tile's area over 256 x 128 (the epilogue, the
# rings' first fill); a split's cost, (LARGE_SPLIT_US + LARGE_SPLIT_PER_US *
# ksplit) times that area (the partials through distributed shared memory);
# and the share of the card clusters of 4 or more blocks fill
LARGE_STEP_US = {(64, 128): 0.61, (128, 128): 0.67, (256, 128): 0.85,
                 (64, 256): 0.87, (128, 256): 1.03}
LARGE_BITS_STEP = {1: 1.0, 2: 1.0, 3: 1.0, 4: 1.0, 8: 1.27}
LARGE_FIXED_US, LARGE_AREA_US = 2.9, 6.8
LARGE_SPLIT_US, LARGE_SPLIT_PER_US = 3.1, 0.2
LARGE_WIDE_FILL = 0.945


def large_raw_bytes(bits: int, bn: int) -> int:
    """The packed bytes of one K3 step at bn columns: LARGE_STEP / F packed
    rows of each plane (F = decode_fields(bits); three planes' rows at bits
    3: lo rows r and r + Kp/8, hi rows r)."""
    return LARGE_STEP // decode_fields(bits) * decode_planes(bits) * bn


def large_smem(bits: int, bm: int, bn: int):
    """(ring stages, packed stages, bytes) of K3's shared memory at a tile
    of bm token rows x bn columns, as k3::Layout sizes it: 1024 bytes of
    alignment slack; stages of A (bm x 128 bytes) and B (bn x 128 bytes),
    as many as fit, at most LARGE_MAX_STAGES; the packed ring, as many
    steps as 32 KB holds, 4 to 8 (32 KB at bits 2, 64 KB at bits 8); the
    barriers; the epilogue's scales and zero points."""
    raw = large_raw_bytes(bits, bn)
    raws = min(8, max(4, 32768 // raw))
    stage = (bm + bn) * LARGE_STEP

    def total(stages):
        return 1024 + stages * stage + raws * raw + 16 * (stages + raws) + 8 * bn
    stages = LARGE_MAX_STAGES
    while stages > 2 and total(stages) > DECODE_SMEM_LIMIT:
        stages -= 1
    return stages, raws, total(stages)


def large_recv(bm: int, bn: int, ksplit: int) -> int:
    """Bytes a block receives of its cluster's partials: ksplit sources x
    the row groups of 8 it finishes x bn columns of int32."""
    return ksplit * cdiv(bm // 8, ksplit) * 8 * bn * 4


def check_large(N: int, Kp: int, Mp: int, bits: int, bm: int, bn: int,
                ksplit: int) -> None:
    """Raise unless K3 takes these shapes at a tile of bm token rows x bn
    columns and a cluster of ksplit blocks along K (large_plan's, or
    forced)."""
    if bits not in (1, 2, 3, 4, 8):
        raise ValueError(f"K3 takes bits 1 to 4 and 8, not {bits}")
    if N < LARGE_N or Kp <= 0 or Kp % 16 or Kp % (4 * decode_fields(bits)) or Mp % 128:
        raise ValueError(f"K3 takes N >= {LARGE_N}, Kp % 16 == 0 (Kp % 32 at bits 1 and 3) "
                         f"and Mp % 128 == 0, not N = {N}, Kp = {Kp}, Mp = {Mp}")
    if (bm, bn) not in LARGE_TILES or (bits != 2 and bn != 128):
        raise ValueError(f"K3: a tile of {bm} x {bn} at bits {bits}; it takes "
                         f"{LARGE_TILES}, at bits other than 2 those of 128 columns")
    nsteps = cdiv(Kp, LARGE_STEP)
    if not 1 <= ksplit <= min(LARGE_MAX_SPLIT, nsteps):
        raise ValueError(f"K3: a cluster of {ksplit} along {nsteps} steps of K")
    stages, raws, total = large_smem(bits, bm, bn)
    ring = total - 1024 - 16 * (stages + raws) - 8 * bn  # the rings, which receive
    if total > DECODE_SMEM_LIMIT or large_recv(bm, bn, ksplit) > ring:
        raise ValueError(f"K3: tile {bm} x {bn} at ksplit {ksplit} outgrows a block's "
                         "shared memory")


def large_spans(nsteps: int, ksplit: int):
    """The steps [t0, t1) block `rank` of a cluster of ksplit takes: t0 =
    rank * nsteps // ksplit, contiguous and in rank order."""
    return [(r * nsteps // ksplit, (r + 1) * nsteps // ksplit) for r in range(ksplit)]


def large_steps(nsteps: int, ksplit: int, rank: int, tile: int):
    """The steps block `rank` of column tile `tile`'s cluster walks, in its
    order: its span of large_spans, started at its tile index (mod the
    span's length), so that the blocks of a wave read different codes from
    L2 at once.  Integer sums make the order immaterial to the result."""
    t0, t1 = large_spans(nsteps, ksplit)[rank]
    nb = t1 - t0
    return [t0 + (t + tile % nb) % nb for t in range(nb)] if nb else []


def large_plan(N: int, Kp: int, Mp: int, bits: int, sms: int = DEFAULT_SMS):
    """(bm, bn, ksplit) for K3 from shapes only, so a CUDA graph can
    capture the call: the tile (LARGE_TILES) and the cluster size along K
    (1 to LARGE_MAX_SPLIT, no more than the steps) that minimise waves x a
    block's time.  A block holds an SM (its rings take most of the shared
    memory), so a wave is sms // ksplit clusters (LARGE_WIDE_FILL of that
    from 4 blocks a cluster); a block's time is its steps x the tile's step
    time, its fixed time and, split, the split's cost (the constants
    above).  Ties go to the earlier candidate (smaller cluster, then the
    earlier tile).  Raises on shapes K3 does not take.  The tune table's
    (bm, bn, ksplit) for this card and shape wins where it holds one that
    check_large takes (ops/tune_table.py; read only where the file
    exists)."""
    check_large(N, Kp, Mp, bits, *LARGE_TILES[0], 1)
    from tmac_tpu_torch.ops import tune_table
    tuned = tune_table.lookup_large(bits, Kp, Mp, N)
    if tuned is not None:
        try:
            check_large(N, Kp, Mp, bits, *tuned)
            return tuned
        except ValueError:
            pass
    best = None
    for ksplit, (bm, bn) in itertools.product(range(1, LARGE_MAX_SPLIT + 1), LARGE_TILES):
        try:
            check_large(N, Kp, Mp, bits, bm, bn, ksplit)
        except ValueError:
            continue
        fit = sms // ksplit
        if ksplit >= 4:
            fit = int(fit * LARGE_WIDE_FILL)
        waves = cdiv(cdiv(Mp, bn) * cdiv(N, bm), max(fit, 1))
        area = bm * bn / (256 * 128)
        step = LARGE_STEP_US[bm, bn] * LARGE_BITS_STEP[bits]
        block = (cdiv(cdiv(Kp, LARGE_STEP), ksplit) * step + LARGE_FIXED_US
                 + LARGE_AREA_US * area
                 + ((LARGE_SPLIT_US + LARGE_SPLIT_PER_US * ksplit) * area if ksplit > 1 else 0.0))
        cost = waves * block
        if best is None or cost < best[0] - 1e-9:
            best = (cost, (bm, bn, ksplit))
    return best[1]


def large_partials_plain(codes: torch.Tensor, qt: QuantizedTensor,
                         ksplit: int):
    """K3's int32 sums as its K split takes them: codes (N, Kp) in K3's
    order (dp4a_order) against the weight codes in the same order, block
    `rank` of a cluster of ksplit taking the 128-k' steps of large_spans.
    -> ksplit (N, Mp) int64 partials; their sum, in any order, is
    int_dot_plain's."""
    w = dp4a_order(unpack_codes(qt).t(), qt.bits).t().long()
    c = codes.long()
    return [c[:, t0 * LARGE_STEP:t1 * LARGE_STEP] @ w[t0 * LARGE_STEP:t1 * LARGE_STEP]
            for t0, t1 in large_spans(cdiv(qt.kdim_padded, LARGE_STEP), ksplit)]


@functools.cache
def _lib_large():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("qgemm_large")
    lib.tmac_large_int_wgmma.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr,
        _c_ptr, _c_int, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr]
    lib.tmac_large_int_wgmma.restype = _c_int
    return lib


def launch_large_int(codes: torch.Tensor, xs: torch.Tensor, xsum: torch.Tensor,
                     qt: QuantizedTensor, residual=None, ksplit=None,
                     tile=None) -> torch.Tensor:
    """Launch K3's matmul on K1's prologue outputs (large_n on), right
    after the prologue (it starts while the prologue runs): -> (N, Mp)
    f32.  tile (bm, bn) and ksplit: the block's token rows and columns and
    the cluster size along K (large_plan's by default)."""
    res_ptr = _check_gemm_args("K3", codes, xs, xsum, qt, residual)
    N, Kp, Mp = codes.shape[0], qt.kdim_padded, qt.mdim_padded
    if qt.packed.data_ptr() % 16 or _hi_ptr(qt) % 16 or codes.data_ptr() % 16:
        raise ValueError("K3: 16-byte aligned codes and packed weights")
    plan_bm, plan_bn, plan_split = large_plan(N, Kp, Mp, qt.bits, _sms(codes.device))
    (bm, bn), ksplit = tile or (plan_bm, plan_bn), ksplit or plan_split
    check_large(N, Kp, Mp, qt.bits, bm, bn, ksplit)
    out = torch.empty((N, Mp), dtype=torch.float32, device=codes.device)
    err = _lib_large().tmac_large_int_wgmma(
        codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(), N, Kp, qt.bits,
        qt.packed.data_ptr(), _hi_ptr(qt), qt.scales.data_ptr(),
        qt.sub.data_ptr(), Mp, res_ptr, out.data_ptr(), bm, bn, ksplit,
        torch.cuda.current_stream(codes.device).cuda_stream)
    raise_on("K3", err, "matmul")
    return out


def qgemm_large_int(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                    glu: bool = False, residual=None) -> torch.Tensor:
    """K3: qgemm_fused's function for N >= 64 rows, on the reference's
    large-N route (its single int8 dot and that route's epilogue): K1's
    prologue with the bare code sum, then one exact int32 dot over the
    whole depth on the tensor cores (wgmma s8; large_plan's token tile and
    split of K)."""
    _check_supported(qt, glu, norm, residual)
    if x.shape[0] < LARGE_N:
        raise ValueError(f"K3 takes N >= {LARGE_N} rows, not {x.shape[0]}: "
                         "K1 (qgemm_fused) takes fewer")
    if not _on_device("K3", x):
        return qgemm_fused_plain(x, qt, norm, glu, residual)
    codes, xs, xsum = launch_act_quant(x, qt, norm, glu, large_n=True)
    out = launch_large_int(codes, xs, xsum, qt, residual)
    qgemm_large_int.launches += 1
    return qt.slice_m(out)


qgemm_large_int.launches = 0


# ---------------------------------------------------------------------------
# E1: the external-int8 form (int8 x, one scale row)
# ---------------------------------------------------------------------------

def _check_int8_x(qt: QuantizedTensor, x: torch.Tensor, residual) -> None:
    _check_supported(qt, False, None, residual)
    if x.dtype != torch.int8 or x.dim() != 2 or x.shape[1] != qt.kdim:
        raise ValueError(f"E1 takes int8 x (N, {qt.kdim}), not {x.dtype} {tuple(x.shape)}")


def int8_x_plain(x: torch.Tensor, qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """E1 in plain PyTorch: the caller's int8 codes x (N, K), their exact
    int32 dot with the weight codes and the reference's non-fused epilogue
    fma(acc, scale, -(xsum * sub)) (+ residual), xsum the bare code sum:
    K3's epilogue with xs = 1.  -> (N, M) f32."""
    _check_int8_x(qt, x, residual)
    codes = pad_x_for(x, qt)
    xsum = codes.to(torch.int32).sum(1).float()
    acc = int_dot_plain(codes, qt)
    return qt.slice_m(large_epilogue_plain(acc, torch.ones_like(xsum), xsum, qt, residual))


def qgemm_int8_x(x: torch.Tensor, qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """E1: int8 x (N, K) @ Wdq -> (N, M) f32 for one scale row, the
    reference's exact int32 route for int8 x: K1's matmul (its EXT
    instance) below LARGE_N rows, K3's from there.  CPU tensors take
    int8_x_plain."""
    _check_int8_x(qt, x, residual)
    if not _on_device("E1", x):
        return int8_x_plain(x, qt, residual)
    codes = pad_x_for(x, qt).contiguous()
    xsum = codes.sum(1, dtype=torch.int32).float()
    if codes.shape[0] < LARGE_N:
        out = launch_decode(codes, None, xsum, qt, residual)
    else:
        out = launch_large_int(dp4a_order(codes, qt.bits).contiguous(), torch.ones_like(xsum),
                               xsum, qt, residual)
    qgemm_int8_x.launches += 1
    return qt.slice_m(out)


qgemm_int8_x.launches = 0
