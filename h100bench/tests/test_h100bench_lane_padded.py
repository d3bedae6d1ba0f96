"""The reader of ``k1_lane_padded.batch``: found by name, it reads the
program's counters ``k1.launches.lane_padded`` over ``k1.launches`` as a
percentage, and nothing where no device work was traced, where K1 never
ran or where the program keeps no such counter (a program before it was
added, which still counts launches)."""

import sys
from types import SimpleNamespace

import pytest

import h100bench_tiny as tiny
from h100bench.spec import Spec

NAME = "k1_lane_padded.batch"
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


@pytest.mark.parametrize("launches,padded,expect", [
    (52, 52, 100.0),  # every launch on operands at 8-lane subspaces
    (52, 0, 0.0),  # held decoded: the operands keep their width
    (4, 1, 25.0),  # one padded launch of four
], ids=["all", "none", "mixed"])
def test_it_reads_padded_launches_over_launches(read, monkeypatch, launches, padded, expect):
    _counters(monkeypatch, {"k1.launches": launches, "k1.launches.lane_padded": padded,
                            "k1.blocks": 7824 * launches})
    assert read(_ctx(TRACED)) == pytest.approx(expect)


def test_it_reads_nothing_without_device_work_or_counters(read, monkeypatch):
    _counters(monkeypatch, {"k1.launches": 8, "k1.launches.lane_padded": 8})
    assert read(_ctx([])) is None
    _counters(monkeypatch, {"k1.launches": 4, "k1.blocks": 31296})  # no lane counter yet
    assert read(_ctx(TRACED)) is None
    _counters(monkeypatch, {"k1.launches": 0, "k1.launches.lane_padded": 0})  # K1 never ran
    assert read(_ctx(TRACED)) is None


def test_a_program_without_counters_reads_nothing(read, monkeypatch):
    import gulon_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing", raising=False)  # set only once something imported it
    monkeypatch.setitem(sys.modules, "gulon_tpu_torch.utils.tracing", None)
    assert read(_ctx(TRACED)) is None
