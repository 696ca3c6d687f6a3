"""The port's multi-process entry wiring (``sdpgs_torch/parallel/
distributed.py``) against the contract of sdpgs_tpu's: the same flags and
``SDPGS_*`` environment, ``torch.distributed.init_process_group`` in place
of ``jax.distributed.initialize`` (monkeypatched here: nothing is formed)."""

from types import SimpleNamespace
from unittest import mock

import pytest

from sdpgs_torch.parallel import distributed as tdist


def _args(**kw):
    base = dict(dist_coordinator="", dist_num_processes=None, dist_process_id=None)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.fixture
def init(monkeypatch):
    for k in ("SDPGS_COORDINATOR", "SDPGS_NUM_PROCESSES", "SDPGS_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    with mock.patch("torch.distributed.init_process_group") as fn:
        yield fn


def test_noop_without_flags(init):
    assert tdist.maybe_initialize_distributed(_args()) is False
    assert tdist.maybe_initialize_distributed(None) is False
    init.assert_not_called()


def test_explicit_flags_forwarded(init):
    ok = tdist.maybe_initialize_distributed(_args(
        dist_coordinator="10.0.0.1:8476", dist_num_processes=2, dist_process_id=1),
        backend="gloo")
    assert ok
    init.assert_called_once_with(backend="gloo", init_method="tcp://10.0.0.1:8476",
                                 world_size=2, rank=1, timeout=tdist.TIMEOUT)


def test_auto_uses_env_init(init):
    assert tdist.maybe_initialize_distributed(_args(dist_coordinator="auto"), backend="gloo")
    init.assert_called_once_with(backend="gloo", init_method="env://", timeout=tdist.TIMEOUT)


def test_env_fallback(init, monkeypatch):
    monkeypatch.setenv("SDPGS_COORDINATOR", "host0:1234")
    monkeypatch.setenv("SDPGS_NUM_PROCESSES", "4")
    monkeypatch.setenv("SDPGS_PROCESS_ID", "3")
    assert tdist.maybe_initialize_distributed(None, backend="gloo")
    init.assert_called_once_with(backend="gloo", init_method="tcp://host0:1234", world_size=4,
                                 rank=3, timeout=tdist.TIMEOUT)


def test_partial_flags_rejected(init):
    with pytest.raises(SystemExit):
        tdist.maybe_initialize_distributed(_args(dist_coordinator="10.0.0.1:8476"))
    with pytest.raises(SystemExit):
        tdist.maybe_initialize_distributed(_args(dist_num_processes=2, dist_process_id=0))
    init.assert_not_called()


def test_train_cli_parses_dist_flags():
    from sdpgs_torch.cli.train_cli import build_parser, config_from_args

    args = build_parser().parse_args([
        "-s", "/tmp/x", "--dist_coordinator", "h:1", "--dist_num_processes", "2",
        "--dist_process_id", "0", "--mesh", "data=2"])
    assert args.dist_coordinator == "h:1"
    assert args.dist_num_processes == 2
    assert args.dist_process_id == 0
    cfg = config_from_args(args)
    assert (cfg.mesh_data, cfg.mesh_gauss, cfg.mesh_tile) == (2, 1, 1)
