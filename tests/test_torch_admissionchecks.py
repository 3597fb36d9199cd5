"""The port's admission-check controllers against the JAX package's.

Every case of tests/test_admissionchecks.py runs on both packages
(tests/torch_twin.py): provisioning (the ProvisioningRequest per check,
Provisioned -> Ready with podSetUpdates, Failed -> retries with backoff
and jitter, then Rejected) and MultiKueue with two worker managers in one
process (the first reserving cluster wins, the remote finish copied
back, a lost worker's Retry after the timeout, the batch Job mirrored,
gc_orphans by hand and on its timer, loss and rejoin without a double
dispatch). The stores of the manager and of every worker are equal after
every drain and every cycle, and the events in order, with no tolerance.
"""

import inspect

import pytest

from tests.torch_twin import assert_twins, load_twin


def case_names(modname: str) -> list:
    mod = load_twin(modname, "kueue_tpu")
    names = []
    for n, obj in vars(mod).items():
        if n.startswith("Test") and inspect.isclass(obj):
            names += [f"{n}.{m}" for m in vars(obj) if m.startswith("test_")]
        elif n.startswith("test_") and inspect.isfunction(obj):
            names.append(n)
    return names


CASES = case_names("tests.test_admissionchecks")


def test_every_admission_check_case_is_paired():
    assert len(CASES) == 11


@pytest.mark.parametrize("test", CASES)
def test_admission_check_case(test):
    assert_twins("tests.test_admissionchecks", test)


def test_multikueue_feeds_the_cluster_columns():
    """The manager wires the MultiKueue controller as the cache's capacity
    source and the scheduler's placement sink."""
    from kueue_tpu_torch.api.meta import FakeClock
    from kueue_tpu_torch.manager import KueueManager
    clock = FakeClock(0.0)
    worker = KueueManager(clock=clock)
    mgr = KueueManager(clock=clock, remote_clusters={"w": worker})
    assert mgr.cache.remote_capacity_source == mgr.multikueue.capacity_columns
    assert mgr.scheduler.on_placement == mgr.multikueue.note_placement
    assert mgr.multikueue.journeys is mgr.journey_ledger
    mgr.shutdown()
    worker.shutdown()
