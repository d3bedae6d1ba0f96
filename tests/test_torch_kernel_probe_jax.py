"""Port parity: P3 (``gulon_tpu_torch/probes/kernel_probe.py``) against the
TPU probe itself, ``benchmarks/kernel_probe.py``, run on the CPU.

The TPU probe's variants are closures inside its ``main()``. Each case runs
that ``main()`` at ``PROBE_N=4096 PROBE_M=4 PROBE_T=1024 PROBE_QT=512`` (four
1024-row tiles, two 512-query tiles, m 4 x K 256 x dsub 13, mdp 128) with
``pl.pallas_call`` in interpret mode (its outputs recorded), ``jax.jit`` the
identity (so the outputs are arrays, not tracers), ``time_device_loop`` one
call of the step and the persistent cache a no-op. The port's
``kernel_probe(..., device="cpu")`` (the plain version) gets the same
operands, drawn as the TPU probe draws them (``kernel_probe.py:41-47``,
``jax.random.key(0)``), as numpy arrays.

Tolerance: ids equal on at least 99.5 % of the entries (all of them on the
``tdec_*`` variants); values within ``2^-14 * max(|v|, 1)``, the rule of
``chip_smoke._p3_check``: both sides sum exact bf16 x bf16 products in f32,
in different orders. ``noop`` and ``grid`` write zeros exactly.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import benchmarks.common
import benchmarks.kernel_probe as tpu_probe
import gulon_tpu.utils.cache
from gulon_tpu_torch.probes import kernel_probe as kp

torch.set_num_threads(2)

SHAPE = dict(PROBE_N="4096", PROBE_M="4", PROBE_T="1024", PROBE_QT="512")


def _tpu_outputs(monkeypatch, variant):
    """``(vals, ids)`` the TPU probe's kernel writes for ``variant``."""
    for name, value in SHAPE.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(sys, "argv", ["kernel_probe.py", variant])
    outputs = []
    pallas_call = pl.pallas_call

    def interpreted(*args, **kwargs):
        call = pallas_call(*args, **dict(kwargs, interpret=True))

        def run(*operands):
            out = call(*operands)
            outputs.append(tuple(np.asarray(o) for o in out))
            return out

        return run

    def once(step, carry_probe, iters=16):
        carry_probe(step(jnp.float32(0.0)))
        return 0.0

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(jax, "jit", lambda fn=None, **kw: fn if fn is not None else (lambda f: f))
    monkeypatch.setattr(benchmarks.common, "time_device_loop", once)
    monkeypatch.setattr(gulon_tpu.utils.cache, "enable_persistent_cache", lambda *a, **k: "")
    tpu_probe.main()
    assert len(outputs) == 1, f"{variant}: {len(outputs)} kernel calls"
    return outputs[0]


def _tpu_operands():
    """The TPU probe's operands (``kernel_probe.py:41-47``) as numpy."""
    n, m, k_codes, dsub, num_q, t = 4096, 4, 256, 13, 1024, 1024
    mdp = max(-(-(m * dsub) // 8) * 8, 128)
    npad = -(-n // t) * t
    key = jax.random.key(0)
    codes_t = jax.random.randint(key, (m, npad), 0, k_codes, jnp.int32)
    norms = jax.random.uniform(key, (1, npad), jnp.float32)
    q_pad = jax.random.normal(key, (num_q, mdp), jnp.float32).astype(jnp.bfloat16)
    cb = jax.random.normal(key, (m, k_codes, dsub), jnp.float32).astype(jnp.bfloat16)
    return tuple(np.array(a) for a in (codes_t, norms, q_pad.astype(jnp.float32),
                                       cb.astype(jnp.float32)))


@pytest.fixture(scope="module")
def tpu_operands():
    return _tpu_operands()


@pytest.mark.parametrize("variant", kp.VARIANTS)
def test_p3_plain_matches_the_tpu_probe(monkeypatch, tpu_operands, variant):
    ref_v, ref_i = _tpu_outputs(monkeypatch, variant)
    codes_t, norms, q_pad, cb = tpu_operands
    vals, ids = kp.kernel_probe(
        variant, codes_t, norms, torch.from_numpy(q_pad).to(torch.bfloat16),
        torch.from_numpy(cb).to(torch.bfloat16), tile_rows=1024, query_tile=512, device="cpu",
    )
    vals, ids = vals.numpy(), ids.numpy()
    assert vals.shape == ref_v.shape == (32, 1024) and ids.shape == ref_i.shape
    assert vals.dtype == np.float32 and ids.dtype == ref_i.dtype == np.int32
    tol = 2.0 ** -14 * np.maximum(np.abs(ref_v), 1.0)
    assert np.all(np.abs(vals - ref_v) <= tol), float(np.abs(vals - ref_v).max())
    same = float(np.mean(ids == ref_i))
    assert same == 1.0 if variant.startswith("tdec_") else same >= 0.995, same
    if kp.spec(variant)[0] in ("noop", "grid"):
        assert not ref_v.any() and not ref_i.any()
        assert not vals.any() and not ids.any()
