"""Test helpers.

Counterpart of `robogym_tpu/utils/testing.py`."""

import numpy as np
import torch


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_dict_match(a: dict, b: dict, eps: float = 1e-8):
    """Recursively assert two (possibly nested) dicts of tensors, arrays
    or scalars match: same key sets, numeric leaves within eps (tensors on
    any device), others equal."""
    assert set(a.keys()) == set(b.keys()), (
        f"key mismatch: {sorted(a)} vs {sorted(b)}"
    )
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, dict):
            assert_dict_match(va, vb, eps)
        elif isinstance(va, (int, float, np.ndarray, torch.Tensor)) or hasattr(va, "shape"):
            assert np.allclose(_host(va), _host(vb), atol=eps), (
                f"value mismatch for key {k!r}: {va} vs {vb}"
            )
        else:
            assert va == vb, f"value mismatch for key {k!r}: {va} vs {vb}"
