"""Pipeline-stage parallelism: the SRCNN stack split across a ``stage``
mesh axis, frames streaming from device to device (GPipe-style schedule).

This fills the last row of SURVEY.md §2's parallelism table ("Optional
stage pipelining (resize -> conv1 -> conv2 -> conv3) across devices for
streaming video").  The reference has no analog at all -- its stages are
sequential CPU loops over one image (`libsrcnn.cpp:628-923`); here each
device owns a contiguous group of stages and a clip of N frames flows
through the chain in ``N + S - 1`` systolic steps:

* step ``t``: device ``s`` works on frame ``t - s`` (when in range), then
  hands its activation to device ``s + 1`` via ``lax.ppermute`` -- the
  only inter-device traffic, one [C, H', W'] buffer per step.
* the whole schedule is a single ``lax.scan`` inside one ``shard_map``;
  per-device stage dispatch is a ``lax.switch`` on ``axis_index`` (SPMD:
  one program, device-varying branch).

Activations are carried in a fixed packed layout so every stage maps
buffer -> buffer (a requirement of both ``ppermute`` and ``switch``):
channels ``[0:k)`` hold the live Y-path activation (k = 1/64/32/d+1),
channels ``[C-(d-1):C)`` carry the resized chroma planes untouched until
the final merge.  C = 64 + d - 1.

The per-stage math reuses the exact single-device ops (same
``precision=HIGHEST`` convs, same resize gather, same color converters),
so the pipelined output is bit-identical to :func:`libsrcnn_tpu.upscale`
-- asserted by tests/test_stages.py.  The fused kernel is a single
device op by design and cannot be split across stage boundaries; this
path always uses the XLA convs (``use_pallas`` is ignored, like the GSPMD
spatial path -- see PARITY.md).

When to use it: steady-frame streaming where per-device memory, not
throughput, is the binding constraint (each device holds only its stage's
weights and one activation buffer).  For throughput, batched data
parallelism (`sharding.upscale_batch`) keeps every device busier -- the
pipeline has an ``S - 1`` bubble and ships whole activation planes
between devices every step.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import FilterType, SRCNNConfig, chroma_filter
from ..models import srcnn
from ..ops import color, resize
from .. import pipeline

#: supported pipeline depths: contiguous groupings of the four atomic
#: stages [resize+color, conv1, conv2, conv3+merge]
_GROUPINGS = {
    2: ((0, 1), (2, 3)),   # conv1 dominates FLOPs; pair it with resize
    3: ((0, 1), (2,), (3,)),
    4: ((0,), (1,), (2,), (3,)),
}


def _state_helpers(C: int, n_chroma: int, dst_h: int, dst_w: int):
    """Shared packed-state layout for the carry-less atom builders
    (:func:`_atoms`, :func:`_atoms_generic`): channels ``[0:k)`` live
    activation, tail the chroma planes, zero fill between (the vdsr
    builder keeps its own variant -- it reserves a carry channel for the
    residual identity path)."""
    def pack(act, chroma):
        fill = C - act.shape[0] - n_chroma
        parts = [act.astype(jnp.float32)]
        if fill:
            parts.append(jnp.zeros((fill, dst_h, dst_w), jnp.float32))
        if n_chroma:
            parts.append(chroma)
        return jnp.concatenate(parts, axis=0)

    def chroma_of(state):
        return state[C - n_chroma:] if n_chroma else state[:0]

    return pack, chroma_of


def _chw_conv(conv_same):
    """[C,H,W]-state SAME conv atom body over a family's conv_same."""
    def conv(x_chw, w, b, relu=True):
        h = conv_same(x_chw.transpose(1, 2, 0)[None], w) + b
        h = jnp.maximum(h, 0.0) if relu else h
        return h[0].transpose(2, 0, 1)

    return conv


def _atoms(params, d, dst_h, dst_w, y_filter, c_filter, n_chroma):
    """The four atomic stage functions, each mapping
    (packed [C,H',W'] f32 state, [H,W,D] u8 frame) -> packed state."""
    C = 64 + n_chroma
    pack, chroma_of = _state_helpers(C, n_chroma, dst_h, dst_w)

    def a_resize(state, frame):
        planes = color.rgb_to_ycbcr(frame)  # [D,H,W] f32
        y_r = resize.resize_plane(planes[0], dst_h, dst_w, y_filter)
        rest = [resize.resize_plane(planes[c], dst_h, dst_w, c_filter)
                for c in range(1, d)]
        chroma = jnp.stack(rest) if rest else None
        return pack(y_r[None], chroma)

    def a_conv1(state, frame):
        x = state[0][None, :, :, None]  # NHWC
        h1 = srcnn._conv(srcnn.edge_pad(x, 4), params["w1"]) + params["b1"]
        h1 = jnp.maximum(h1, 0.0)
        return pack(h1[0].transpose(2, 0, 1), chroma_of(state))

    def a_conv2(state, frame):
        x = state[:64].transpose(1, 2, 0)[None]  # NHWC
        h2 = srcnn._conv(x, params["w2"]) + params["b2"]
        h2 = jnp.maximum(h2, 0.0)
        return pack(h2[0].transpose(2, 0, 1), chroma_of(state))

    def a_conv3(state, frame):
        x = state[:32].transpose(1, 2, 0)[None]  # NHWC
        h3 = srcnn._conv(srcnn.edge_pad(x, 2), params["w3"]) + params["b3"]
        y_sr = jnp.clip(h3[0, :, :, 0], 0.0, 255.0)
        merged = jnp.concatenate([y_sr[None], chroma_of(state)], axis=0)
        out_u8 = color.ycbcr_to_rgb(merged)  # [H',W',D] u8
        conv_u8 = jnp.floor(y_sr)  # truncating cast (`libsrcnn.cpp:897-901`)
        # final packed state: ch 0..d-1 = RGB planes, ch d = conv map
        # (u8 values are exact in f32, so the round-trip is lossless)
        return pack(
            jnp.concatenate(
                [out_u8.transpose(2, 0, 1).astype(jnp.float32), conv_u8[None]]
            ),
            chroma_of(state),
        )

    return [a_resize, a_conv1, a_conv2, a_conv3]


def _atoms_generic(params, spec, d, dst_h, dst_w, y_filter, c_filter,
                   n_chroma):
    """Atomic stages for the generic srcnn family (model="srcnn955"):
    the same [resize, conv1, conv2, conv3+merge] split as the 9-1-5
    atoms, but per-layer replicate-padded SAME convs at the spec's
    kernel sizes/filter counts (srcnn_generic.forward_hr semantics).
    C = n1 + n_chroma (n1 >= n2 and >= d+1 for every sane spec)."""
    from ..models.srcnn_generic import _conv_same

    C = spec.n1 + n_chroma
    if spec.n1 < d + 1:
        raise ValueError(f"n1={spec.n1} too narrow to carry the output")
    if spec.n2 > spec.n1:
        # pack() fills the state to C = n1 + n_chroma channels; a wider
        # conv2 output would need a negative fill (obscure jnp.zeros
        # trace error) -- reject up front
        raise ValueError(f"n2={spec.n2} > n1={spec.n1}: the stage state "
                         f"carries n1 + chroma channels")
    pack, chroma_of = _state_helpers(C, n_chroma, dst_h, dst_w)
    conv = _chw_conv(_conv_same)

    def a_resize(state, frame):
        planes = color.rgb_to_ycbcr(frame)
        y_r = resize.resize_plane(planes[0], dst_h, dst_w, y_filter)
        rest = [resize.resize_plane(planes[c], dst_h, dst_w, c_filter)
                for c in range(1, d)]
        chroma = jnp.stack(rest) if rest else None
        return pack(y_r[None], chroma)

    def a_conv1(state, frame):
        return pack(conv(state[:1], params["w1"], params["b1"]),
                    chroma_of(state))

    def a_conv2(state, frame):
        return pack(conv(state[:spec.n1], params["w2"], params["b2"]),
                    chroma_of(state))

    def a_conv3(state, frame):
        y_sr = jnp.clip(conv(state[:spec.n2], params["w3"], params["b3"],
                             relu=False)[0].astype(jnp.float32), 0.0, 255.0)
        merged = jnp.concatenate([y_sr[None], chroma_of(state)], axis=0)
        out_u8 = color.ycbcr_to_rgb(merged)
        conv_u8 = jnp.floor(y_sr)
        return pack(
            jnp.concatenate(
                [out_u8.transpose(2, 0, 1).astype(jnp.float32),
                 conv_u8[None]]),
            chroma_of(state))

    return [a_resize, a_conv1, a_conv2, a_conv3]


def _atoms_vdsr(params, spec, d, dst_h, dst_w, y_filter, c_filter,
                n_chroma):
    """Atomic stages for the vdsr stack: [resize, in, mid x (depth-2),
    out+residual+merge] -- depth+1 atoms in total, each mapping a packed
    [C, H', W'] state to itself.  Layout: channels [0:ch) live
    activation, channel ch the CARRIED interpolated y (the residual
    identity path must survive to the last stage), tail the chroma
    planes.  C = ch + 1 + n_chroma; the final packed frame (d+1 planes)
    fits because ch >= d + 1 for every shipped spec."""
    from ..models.vdsr import _conv_same

    ch = spec.ch
    C = ch + 1 + n_chroma
    if C < d + 1 + n_chroma:
        raise ValueError(f"vdsr ch={ch} too narrow to carry the output")

    def pack(act, carry, chroma):
        fill = C - act.shape[0] - 1 - n_chroma
        parts = [act.astype(jnp.float32)]
        if fill:
            parts.append(jnp.zeros((fill, dst_h, dst_w), jnp.float32))
        parts.append(carry[None])
        if n_chroma:
            parts.append(chroma)
        return jnp.concatenate(parts, axis=0)

    def carry_of(state):
        return state[C - 1 - n_chroma]

    def chroma_of(state):
        return state[C - n_chroma:] if n_chroma else state[:0]

    conv = _chw_conv(_conv_same)

    def a_resize(state, frame):
        planes = color.rgb_to_ycbcr(frame)
        y_r = resize.resize_plane(planes[0], dst_h, dst_w, y_filter)
        rest = [resize.resize_plane(planes[c], dst_h, dst_w, c_filter)
                for c in range(1, d)]
        chroma = jnp.stack(rest) if rest else None
        return pack(y_r[None], y_r, chroma)

    def a_in(state, frame):
        h = conv(state[:1], params["in_w"], params["in_b"])
        return pack(h, carry_of(state), chroma_of(state))

    def a_mid(l):
        def atom(state, frame):
            h = conv(state[:ch], params["mid_w"][l], params["mid_b"][l])
            return pack(h, carry_of(state), chroma_of(state))

        return atom

    def a_out(state, frame):
        res = conv(state[:ch], params["out_w"], params["out_b"],
                   relu=False)[0]
        y_sr = jnp.clip(carry_of(state).astype(jnp.float32)
                        + res.astype(jnp.float32), 0.0, 255.0)
        merged = jnp.concatenate([y_sr[None], chroma_of(state)], axis=0)
        out_u8 = color.ycbcr_to_rgb(merged)
        conv_u8 = jnp.floor(y_sr)
        return pack(
            jnp.concatenate(
                [out_u8.transpose(2, 0, 1).astype(jnp.float32),
                 conv_u8[None]]),
            carry_of(state), chroma_of(state))

    return ([a_resize, a_in]
            + [a_mid(l) for l in range(spec.depth - 2)]
            + [a_out])


def _balanced_groups(n_atoms: int, n_stages: int):
    """Contiguous split of atom indices into n_stages non-empty groups,
    conv work balanced: atom 0 (resize) is cheap, so it rides with the
    first conv group; the remaining n_atoms-1 convs split evenly."""
    convs = n_atoms - 1
    base, extra = divmod(convs, n_stages)
    groups, k = [], 1
    for s in range(n_stages):
        take = base + (1 if s < extra else 0)
        g = tuple(range(k, k + take))
        if s == 0:
            g = (0,) + g
        groups.append(g)
        k += take
    return tuple(groups)


@functools.lru_cache(maxsize=32)
def _pipelined_fn(n, h, w, d, dst_h, dst_w, filter_type, mesh, axis,
                  model="srcnn", spec=None):
    n_stages = mesh.shape[axis]
    y_filter = FilterType(filter_type)
    c_filter = chroma_filter(y_filter)
    n_chroma = d - 1
    if model == "vdsr":
        groups = _balanced_groups(spec.depth + 1, n_stages)
        C = spec.ch + 1 + n_chroma
    elif model == "srcnn955":
        groups = _GROUPINGS[n_stages]
        C = spec.n1 + n_chroma
    else:
        groups = _GROUPINGS[n_stages]
        C = 64 + n_chroma
    steps = n + n_stages - 1

    def run(frames, params):  # frames [N,H,W,D] u8, replicated
        if model == "vdsr":
            atoms = _atoms_vdsr(params, spec, d, dst_h, dst_w, y_filter,
                                c_filter, n_chroma)
        elif model == "srcnn955":
            atoms = _atoms_generic(params, spec, d, dst_h, dst_w,
                                   y_filter, c_filter, n_chroma)
        else:
            atoms = _atoms(params, d, dst_h, dst_w, y_filter, c_filter,
                           n_chroma)
        branches = [
            (lambda state, frame, g=g: functools.reduce(
                lambda s, a: atoms[a](s, frame), g, state))
            for g in groups
        ]
        stage = lax.axis_index(axis)
        is_last = stage == n_stages - 1
        fwd = [(s, s + 1) for s in range(n_stages - 1)]

        def step(carry, t):
            buf, acc = carry
            frame = lax.dynamic_index_in_dim(
                frames, jnp.minimum(t, n - 1), keepdims=False)
            out = lax.switch(stage, branches, buf, frame)
            # last device banks frame t-(S-1) once it is real
            idx = t - (n_stages - 1)
            valid = jnp.logical_and(is_last, idx >= 0)
            idx = jnp.maximum(idx, 0)
            slot = lax.dynamic_index_in_dim(acc, idx, keepdims=False)
            acc = lax.dynamic_update_index_in_dim(
                acc, jnp.where(valid, out[: d + 1], slot), idx, axis=0)
            # hand the activation down the chain (device 0 gets zeros --
            # it reads fresh frames instead)
            buf = lax.ppermute(out, axis, fwd) if n_stages > 1 else out
            return (buf, acc), None

        buf0 = jnp.zeros((C, dst_h, dst_w), jnp.float32)
        acc0 = jnp.zeros((n, d + 1, dst_h, dst_w), jnp.float32)
        (_, acc), _ = lax.scan(step, (buf0, acc0), jnp.arange(steps))
        return acc[None]  # [1, N, d+1, H', W'] -- stacked over stages

    spec_state = P(axis)
    sharded = shard_map(
        run, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=spec_state,
        check_vma=False,
    )

    @jax.jit
    def fn(frames, params):
        stacked = sharded(frames, params)  # [S, N, d+1, H', W']
        final = stacked[n_stages - 1]
        out_u8 = final[:, :d].transpose(0, 2, 3, 1).astype(jnp.uint8)
        conv_u8 = final[:, d].astype(jnp.uint8)
        return out_u8, conv_u8

    return fn


def upscale_pipelined(frames, params, multiply: float, cfg: SRCNNConfig,
                      mesh: Mesh, axis: str = "stage"):
    """Upscale a clip of frames with the stack pipelined across
    ``mesh.shape[axis]`` devices.

    Args:
      frames: [N, H, W, D] u8 frames (same geometry).
      params: SRCNN params pytree (``pipeline.load_model_params``).
      multiply: scale factor (same semantics as :func:`libsrcnn_tpu.upscale`).
      cfg: model ``"srcnn"`` / ``"srcnn955"`` (4 atoms, 2..4 stages;
        the generic family uses its per-layer replicate-padded convs) or
        ``"vdsr"`` (the deep homogeneous stack -- depth+1 atoms, any
        2..depth+1 stages, residual identity carried through the chain
        in a reserved state channel).  The LR families' learned-upscale
        heads are single fused stages with nothing to pipeline; use
        ``sharding.upscale_batch`` for them.
      mesh: mesh whose ``axis`` axis carries the stages.

    Returns:
      ([N, H', W', D] u8 frames, [N, H', W'] u8 conv maps), bit-identical
      to running :func:`libsrcnn_tpu.upscale` per frame.
    """
    if cfg.self_ensemble:
        raise ValueError("self_ensemble is not implemented for the "
                         "stage-pipelined path; ensemble per frame "
                         "via api.upscale")
    if cfg.step_scale:
        raise ValueError(
            "step_scale is not supported by the stage-pipelined path (it "
            "runs one direct pass; silently skipping the chained-x2 u8 "
            "round trips would break bit-identity with api.upscale) -- "
            "chain upscale_pipelined calls per x2 pass instead")
    n_stages = mesh.shape[axis]
    if cfg.model in ("srcnn", "srcnn955"):
        if n_stages not in _GROUPINGS:
            raise ValueError(
                f"pipeline depth {n_stages} unsupported (axis {axis!r}); "
                f"use {sorted(_GROUPINGS)} stages for {cfg.model}")
    elif cfg.model == "vdsr":
        # the deep homogeneous stack is the NATURAL pipelining case:
        # depth+1 atoms split contiguously, any 2..depth+1 stages
        if not 2 <= n_stages:
            raise ValueError(f"need >= 2 stages, got {n_stages}")
    else:
        raise ValueError(
            "pipeline-stage parallelism applies to the srcnn/srcnn955/"
            f"vdsr stacks; model {cfg.model!r} has a fused learned-"
            "upscale head (use sharding.upscale_batch)")
    if cfg.compute_dtype != "float32":
        raise ValueError(
            "the stage-pipelined path runs exact f32 only (its atoms "
            "carry f32 and would silently diverge from upscale() under "
            f"compute_dtype={cfg.compute_dtype!r}); use per-frame "
            "api.upscale or sharding.upscale_batch for the other tiers")
    n, h, w, d = frames.shape
    dst_w, dst_h = resize.scaled_size(w, h, multiply)
    params, spec = pipeline.prepare_model_params(cfg, params, h, w,
                                                 dst_h, dst_w, multiply)
    if cfg.model == "vdsr" and n_stages > spec.depth + 1:
        raise ValueError(
            f"{n_stages} stages exceed the {spec.depth + 1} vdsr atoms")
    fn = _pipelined_fn(n, h, w, d, dst_h, dst_w, int(cfg.filter), mesh,
                       axis, cfg.model, spec)
    return fn(jnp.asarray(frames), params)
