"""The reader of ``ivf_select_keys.batch``: found by name, it reads the
program's counters ``ivf.select_keys`` over ``ivf.selects`` in millions,
and nothing where no device work was traced, where the program keeps no
such counters (a program before they were added) or where the IVF K1
route never ran."""

import sys
from types import SimpleNamespace

import pytest

import h100bench_tiny as tiny
from h100bench.spec import Spec

NAME = "ivf_select_keys.batch"
TRACED = [("adc_scan_kernel", 0, 1000)]


def _ctx(kernels):
    return SimpleNamespace(view=SimpleNamespace(kernels=kernels, units=1), config={},
                           traffic={}, peaks=None)


@pytest.fixture
def read():
    return Spec(tiny.REPO).metric_reader(NAME)


def _counters(monkeypatch, counters):
    from gulon_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": {}, "counters": counters})


@pytest.mark.parametrize("selects,keys,expect", [
    (4, 4 * 1024 * 83_088 * 4, 340.328448),  # deep96: 83,088 blocks of 128 rows, 4 winners
    (3, 3 * 1024 * 8_256 * 4, 33.816576),  # sift128: 8,256 blocks
])
def test_it_reads_keys_a_select_in_millions(read, monkeypatch, selects, keys, expect):
    _counters(monkeypatch, {"k1.launches": selects, "ivf.selects": selects,
                            "ivf.select_keys": keys})
    assert read(_ctx(TRACED)) == pytest.approx(expect)


def test_it_reads_nothing_without_device_work_or_counters(read, monkeypatch):
    _counters(monkeypatch, {"ivf.selects": 2, "ivf.select_keys": 10**8})
    assert read(_ctx([])) is None
    _counters(monkeypatch, {"k1.launches": 4})  # a program that does not count selects
    assert read(_ctx(TRACED)) is None
    _counters(monkeypatch, {"ivf.selects": 0, "ivf.select_keys": 0})  # the route never ran
    assert read(_ctx(TRACED)) is None


def test_a_program_without_counters_reads_nothing(read, monkeypatch):
    import gulon_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing", raising=False)  # set only once something imported it
    monkeypatch.setitem(sys.modules, "gulon_tpu_torch.utils.tracing", None)
    assert read(_ctx(TRACED)) is None
