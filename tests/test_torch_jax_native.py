"""``tests/torch_jax_native.py``, the port tests' guard against the JAX
package's numpy fallback: a process left as a lost build race leaves it
(``_tried`` set, no library) gets the C++ library back, and a missing or
half-written library file is rebuilt in place without a stray file."""

import os
import shutil

import numpy as np
import pytest

from habitat_tpu import native
from habitat_tpu.sims.scene import geodesic_field

from tests import torch_jax_native


def _field_is_native():
    occ = np.ones((9, 9), bool)
    occ[4, 1:8] = False
    want = native.geodesic_field_native(occ, np.array([[0, 4]]), 0.1)
    return want is not None and np.array_equal(geodesic_field(occ, np.array([[0, 4]]), 0.1), want)


def test_lost_race_state_is_recovered(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert native.get_lib() is None  # what a worker that lost the race keeps
    lib = torch_jax_native.ensure_loaded()
    assert lib is not None and native.get_lib() is lib and native.available()
    assert _field_is_native()


@pytest.mark.parametrize("state", ["missing", "truncated"])
def test_library_file_rebuilt_in_place(tmp_path, monkeypatch, state):
    shutil.copy(os.path.join(native._DIR, "habitat_native.cpp"), tmp_path)
    so = str(tmp_path / "libhabitat_native.so")
    if state == "truncated":
        with open(so, "wb") as f:
            f.write(b"\x7fELF\x02\x01\x01" + bytes(57))  # an ELF header with nothing after it
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SO", so)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    lib = torch_jax_native.ensure_loaded()
    assert lib is not None and lib._name == so
    assert sorted(os.listdir(tmp_path)) == ["habitat_native.cpp", "libhabitat_native.so"]
    assert _field_is_native()
