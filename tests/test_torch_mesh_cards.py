"""One process over several cards, on the CPU: the slot runner of
lut_ldpc_torch/parallel (``run_by_device``) and the launch guard of the
kernel wrappers (``qc_kernels.launch_on``).

The runner groups a process's slots by device: each group runs on a host
thread of its own, all groups at once, a group's slots in slot order; one
group runs on the calling thread.  Devices here are plain keys ("a", "b",
...), which the runner treats as it treats cards without making them
current, and each step meets a ``threading.Barrier`` of one party a group:
a runner that took the groups one after another would fail on the
barrier's timeout.  The meshed simulator step goes through the same
runner with real CPU decodes behind three device keys.  A static check
holds every ctypes entry-point call under lut_ldpc_torch/decoder/ inside
the one launch helper, launching on the stream it yields.
"""

import ast
import os
import threading
import time

import numpy as np
import pytest
import torch

from lut_ldpc_torch import sim as tsim
from lut_ldpc_torch.parallel import DPMesh, Slot, make_dp_step, make_dp_step_2d, run_by_device

from mesh_setup import sim_config, small_codec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODER = os.path.join(REPO, "lut_ldpc_torch", "decoder")
BARRIER_S = 20.0  # far above a step here; a serial runner waits this long, then fails
# entry points that only answer a question of the host (no launch)
QUERIES = {"lut_cn_vec", "lut_vn_vec", "lut_cn_width"}


class Recorder:
    """A slot step that records (slot, device, thread, phase) and meets a
    barrier of one party a group at the first slot of each group."""

    def __init__(self, slots, timeout=BARRIER_S):
        firsts = {}
        for i, dev in slots:
            firsts.setdefault(dev, i)
        self.firsts = set(firsts.values())
        self.barrier = threading.Barrier(len(firsts), timeout=timeout)
        self.log = []
        self.lock = threading.Lock()

    def _note(self, i, dev, phase):
        with self.lock:
            self.log.append((i, dev, threading.get_ident(), phase))

    def launch(self, i, dev):
        self._note(i, dev, "launch")
        if i in self.firsts:
            self.barrier.wait()
        return 10 * i

    def read(self, i, out):
        self._note(i, None, "read")
        return (i, out)


SLOTS = [(0, "a"), (1, "b"), (2, "a"), (3, "c"), (4, "b"), (5, "a")]


def test_groups_run_at_once():
    rec = Recorder(SLOTS)
    t0 = time.perf_counter()
    run_by_device(SLOTS, rec.launch)
    assert time.perf_counter() - t0 < BARRIER_S / 2
    assert not rec.barrier.broken


def test_a_serial_runner_fails_on_the_barrier():
    """The control: the same steps taken one after another break the
    barrier after its timeout instead of hanging."""
    rec = Recorder(SLOTS, timeout=0.5)
    with pytest.raises(threading.BrokenBarrierError):
        for i, dev in SLOTS:
            rec.launch(i, dev)


def test_one_device_runs_in_order_on_one_thread():
    rec = Recorder(SLOTS)
    run_by_device(SLOTS, rec.launch, rec.read)
    launches = [(i, dev, tid) for i, dev, tid, phase in rec.log if phase == "launch"]
    by_dev = {}
    for i, dev, tid in launches:
        by_dev.setdefault(dev, []).append((i, tid))
    assert {d: [i for i, _ in v] for d, v in by_dev.items()} == {
        "a": [0, 2, 5], "b": [1, 4], "c": [3]}
    threads = {d: {tid for _, tid in v} for d, v in by_dev.items()}
    assert all(len(t) == 1 for t in threads.values())
    assert len(set.union(*threads.values())) == 3
    assert threading.get_ident() not in set.union(*threads.values())
    # a group reads its slots, in order, on its own thread once all of them
    # were launched
    for dev, slots in by_dev.items():
        (tid,) = threads[dev]
        mine = [(i, phase) for i, _, t, phase in rec.log if t == tid]
        order = [i for i, _ in slots]
        assert mine == [(i, "launch") for i in order] + [(i, "read") for i in order]


def test_results_come_back_in_slot_order():
    rec = Recorder(SLOTS)
    assert run_by_device(SLOTS, rec.launch) == [0, 10, 20, 30, 40, 50]
    rec = Recorder(SLOTS)
    assert run_by_device(SLOTS, rec.launch, rec.read) == [(i, 10 * i) for i, _ in SLOTS]


@pytest.mark.parametrize("slots", [[(0, "cpu"), (1, "cpu"), (2, "cpu")],
                                   [(3, torch.device("cpu"))]],
                         ids=["three slots", "one slot"])
def test_a_single_group_runs_on_the_calling_thread(slots):
    rec = Recorder(slots)
    assert run_by_device(slots, rec.launch, rec.read) == [(i, 10 * i) for i, _ in slots]
    assert {tid for _, _, tid, _ in rec.log} == {threading.get_ident()}


@pytest.mark.parametrize("slots,bad", [(SLOTS, 4), ([(0, "a"), (1, "a")], 1)],
                         ids=["threads", "inline"])
def test_an_exception_reaches_the_caller_and_names_its_slot(slots, bad):
    done = []

    def launch(i, dev):
        if i == bad:
            raise ValueError(f"step {i} failed")
        done.append(i)
        return i

    with pytest.raises(ValueError, match=f"step {bad} failed") as info:
        run_by_device(slots, launch)
    dev = dict(slots)[bad]
    assert f"in mesh slot {bad} on {dev}" in info.value.__notes__
    # the other groups ran to their end; no slot ran elsewhere
    others = [i for i, d in slots if d != dev]
    assert sorted(i for i in done if i in others) == others
    assert bad not in done


def test_of_two_failures_the_first_slot_is_raised():
    def launch(i, dev):
        if i in (3, 1):
            raise KeyError(i)
        return i

    with pytest.raises(KeyError) as info:
        run_by_device(SLOTS, launch)
    assert info.value.args == (1,)


# ---------------------------------------------------------------------------
# the meshed simulator step through the runner, three device keys
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def codec():
    torch.set_num_threads(2)
    return small_codec()


def _keyed_step(sim, threads):
    """sim's slot step on the CPU for a mesh whose devices are keys; notes
    the thread of each key."""
    def step(key, seed, ss, gb, sigma):
        threads.setdefault(key, set()).add(threading.get_ident())
        return sim.slot_step("cpu", seed, ss, gb, sigma)
    return step


def test_meshed_steps_on_threads_equal_the_steps_in_order(codec):
    sim = tsim.BERSim(sim_config(), codec.graph, "cpu", codec=codec)
    mesh = DPMesh([Slot(0, k) for k in ("a", "b", "c", "a", "b", "c")])
    threads = {}
    got = make_dp_step(_keyed_step(sim, threads), mesh)(5, 1, 0.84, 3)
    assert len(threads) == 3 and all(len(t) == 1 for t in threads.values())
    assert threading.get_ident() not in set.union(*threads.values())
    sig = torch.tensor(0.84, dtype=torch.float32)
    want = [sim.step(5, 1, 3 + j, sig) for j in range(6)]
    for name, col in got.items():
        assert col.dtype == np.int64
        assert col.tolist() == [int(w[name]) for w in want], name


def test_the_2d_step_takes_the_same_runner(codec):
    sim = tsim.BERSim(sim_config(), codec.graph, "cpu", codec=codec)
    mesh = DPMesh([Slot(0, k) for k in ("a", "b", "a", "b")], rows=2)
    threads = {}
    got = make_dp_step_2d(_keyed_step(sim, threads), mesh)(2, [0.8, 0.9], 7)
    assert set(threads) == {"a", "b"}
    for name, col in got.items():
        want = [sum(int(sim.step(2, r, 7 + j, torch.tensor(s, dtype=torch.float32))[name])
                    for j in range(2)) for r, s in enumerate((0.8, 0.9))]
        assert col.tolist() == want, name


# ---------------------------------------------------------------------------
# every ctypes launch goes through the launch helper
# ---------------------------------------------------------------------------
def _entry_name(call):
    f = call.func
    return f.attr if isinstance(f, ast.Attribute) and f.attr.startswith("lut_") else None


def _is_guard(item):
    e = item.context_expr
    return (isinstance(e, ast.Call) and
            getattr(e.func, "attr", getattr(e.func, "id", None)) == "launch_on")


def unguarded(source: str) -> tuple:
    """(launch calls checked, the line and entry point of each ctypes launch
    that is not inside ``with launch_on(...) as stream`` or does not pass
    that stream as its last argument)."""
    bad, checked = [], 0

    def visit(node, stream):
        nonlocal checked
        if isinstance(node, ast.With):
            for item in node.items:
                if _is_guard(item) and isinstance(item.optional_vars, ast.Name):
                    stream = item.optional_vars.id
        if isinstance(node, ast.Call):
            name = _entry_name(node)
            if name is not None and name not in QUERIES:
                checked += 1
                last = node.args[-1] if node.args else None
                if stream is None or not (isinstance(last, ast.Name) and last.id == stream):
                    bad.append((node.lineno, name))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            stream = None  # a function body is not inside its definer's guard
        for child in ast.iter_child_nodes(node):
            visit(child, stream)

    visit(ast.parse(source), None)
    return checked, bad


def test_the_checker_finds_a_launch_outside_the_guard():
    src = """
def ok(dev, lib):
    with qk.launch_on(dev) as stream:
        err = lib.lut_cn_block_pass(1, 2, stream)
        lib.lut_cn_vec(0, 3, 8, 1)
def bare(dev, lib):
    lib.lut_latch(1, 2, qk._stream(dev))
def other_stream(dev, lib, s):
    with launch_on(dev) as stream:
        lib.lut_latch(1, 2, s)
def nested(dev, lib):
    with launch_on(dev) as stream:
        def later():
            return lib.lut_latch(1, stream)
"""
    checked, bad = unguarded(src)
    assert checked == 4
    assert [name for _, name in bad] == ["lut_latch"] * 3


def _decoder_sources():
    return sorted(os.path.join(DECODER, n) for n in os.listdir(DECODER) if n.endswith(".py"))


def test_every_ctypes_launch_goes_through_the_launch_helper():
    total = 0
    for path in _decoder_sources():
        with open(path) as f:
            checked, bad = unguarded(f.read())
        total += checked
        assert not bad, f"{os.path.relpath(path, REPO)}: launches outside launch_on: {bad}"
    # the CN and VN passes (frames, generated units, witnesses), the block
    # passes and the three glue kernels
    assert total >= 15


def test_the_wrappers_take_no_other_route_to_the_stream():
    for path in _decoder_sources():
        with open(path) as f:
            src = f.read()
        assert "cuda_stream" not in src or os.path.basename(path) == "qc_kernels.py", path
    with open(os.path.join(DECODER, "qc_kernels.py")) as f:
        assert f.read().count(".cuda_stream") == 1


def test_span_summary_on_made_up_spans():
    """cards_sweep's summary: two cards, two groups; the cards overlap in
    the first group only."""
    from lut_ldpc_torch.cards_sweep import span_summary

    spans = [("cuda:0", 0, 0, 0.0, 1.0, 5.0), ("cuda:1", 0, 1, 0.5, 1.5, 7.0),
             ("cuda:0", 1, 2, 2.0, 3.0, 4.0), ("cuda:1", 1, 3, 3.5, 4.0, 2.0)]
    got = span_summary(spans, 2)
    assert got["step_ms"] == {"cuda:0": {0: 5.0, 1: 4.0}, "cuda:1": {0: 7.0, 1: 2.0}}
    assert got["overlapping"] == [1, 2]
    assert got["group_sizes"] == [2]
    assert got["concurrency"] == pytest.approx([0.75, (2 / 1.5 + 0.75) / 2, 2 / 1.5])


def test_cards_sweep_refuses_without_a_card(capsys):
    """On the CPU the sweep imports what it runs and refuses: no number
    without a card."""
    from lut_ldpc_torch import cards_sweep

    assert cards_sweep.main(["--frames", "8192"]) == 1
    assert "needs CUDA devices" in capsys.readouterr().err
