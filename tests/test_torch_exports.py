"""Every name the JAX package exports has its counterpart in the port."""

import gulon_tpu
import gulon_tpu_torch


def test_every_jax_export_has_a_port():
    missing = sorted(set(gulon_tpu._EXPORTS) - set(gulon_tpu_torch._EXPORTS))
    assert missing == []
    assert len(gulon_tpu._EXPORTS) == 42
    for name in gulon_tpu._EXPORTS:
        assert getattr(gulon_tpu_torch, name) is not None, name
        assert gulon_tpu_torch._EXPORTS[name].startswith("gulon_tpu_torch.")
