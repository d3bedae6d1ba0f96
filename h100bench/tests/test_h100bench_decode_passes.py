"""The reader of ``k1_decode_passes.batch``: found by name, it reads the
program's counters ``k1.block_decodes`` over ``k1.blocks``, and nothing
where no device work was traced, where the program keeps no such
counters (a program before they were added) or where K1 never ran."""

import sys
from types import SimpleNamespace

import pytest

import h100bench_tiny as tiny
from h100bench.spec import Spec

NAME = "k1_decode_passes.batch"
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


@pytest.mark.parametrize("blocks,decodes,expect", [
    (7824, 7824, 1.0),  # held decoded: once a block
    (7824, 8 * 7824, 8.0),  # streamed at 1024 queries: once per query tile
    (3 * 7824, 3 * 7824 + 2 * 8 * 7824, 19 / 3),  # one held launch, two streamed
])
def test_it_reads_block_decodes_over_blocks(read, monkeypatch, blocks, decodes, expect):
    _counters(monkeypatch, {"k1.launches": 3, "k1.blocks": blocks, "k1.block_decodes": decodes})
    assert read(_ctx(TRACED)) == pytest.approx(expect)


def test_it_reads_nothing_without_device_work_or_counters(read, monkeypatch):
    _counters(monkeypatch, {"k1.blocks": 10, "k1.block_decodes": 80})
    assert read(_ctx([])) is None
    _counters(monkeypatch, {"k1.launches": 4})  # a program that does not count blocks
    assert read(_ctx(TRACED)) is None
    _counters(monkeypatch, {"k1.blocks": 0, "k1.block_decodes": 0})  # K1 never ran
    assert read(_ctx(TRACED)) is None


def test_a_program_without_counters_reads_nothing(read, monkeypatch):
    import gulon_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing", raising=False)  # set only once something imported it
    monkeypatch.setitem(sys.modules, "gulon_tpu_torch.utils.tracing", None)
    assert read(_ctx(TRACED)) is None
