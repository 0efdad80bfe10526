"""The port's leveled, rank-tagged logging (the cases of
``tests/test_logging.py``: a higher level is more verbose, logging.hpp), and
the log line ``DistributedDomain.realize()`` writes."""

import importlib
import re
import warnings

import pytest
import torch

from stencil_tpu_torch.utils import logging as slog


@pytest.fixture
def reimport(monkeypatch, capsys):
    """``reimport(level, **env)`` sets ``STENCIL_OUTPUT_LEVEL`` (unset for
    None) and any other variables, re-runs the module's import-time parse,
    logs at three levels and returns what went to stderr.  The module's
    level and timestamp switch are restored afterwards."""
    saved = slog._LEVEL, slog._TIMESTAMPS

    def run(level, **env):
        if level is None:
            monkeypatch.delenv("STENCIL_OUTPUT_LEVEL", raising=False)
        else:
            monkeypatch.setenv("STENCIL_OUTPUT_LEVEL", level)
        monkeypatch.delenv("STENCIL_LOG_TIMESTAMPS", raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        capsys.readouterr()
        importlib.reload(slog)
        slog.log_spew("s")
        slog.log_info("i")
        slog.log_error("e")
        return capsys.readouterr().err

    yield run
    slog._LEVEL, slog._TIMESTAMPS = saved


def test_symbolic_name_accepted(reimport):
    err = reimport("SPEW")
    assert "SPEW" in err and "INFO" in err and "ERROR" in err


def test_higher_is_more_verbose(reimport):
    assert "SPEW" in reimport("5")  # SPEW: everything prints
    err = reimport("1")  # ERROR: only errors
    assert "SPEW" not in err and "INFO" not in err and "ERROR" in err


def test_default_is_info(reimport):
    err = reimport(None)
    assert "INFO" in err and "SPEW" not in err


def test_garbage_level_does_not_crash_import(reimport):
    err = reimport("bogus")
    assert "unrecognized" in err and "INFO[" in err


def test_timestamps_opt_in(reimport):
    """STENCIL_LOG_TIMESTAMPS=1 prefixes an ISO-8601 UTC time; the default
    line has none; a malformed value warns and stays off."""
    iso = r"^\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}\.\d{6}\+00:00 INFO\["
    for value in ("1", "true"):
        lines = [line for line in reimport(None, STENCIL_LOG_TIMESTAMPS=value).splitlines()
                 if "INFO" in line]
        assert lines and re.match(iso, lines[0]), lines
    lines = [line for line in reimport(None).splitlines() if "INFO" in line]
    assert lines and lines[0].startswith("INFO["), lines
    err = reimport(None, STENCIL_LOG_TIMESTAMPS="bogus")
    assert "STENCIL_LOG_TIMESTAMPS" in err
    lines = [line for line in err.splitlines() if "INFO[" in line]
    assert lines and lines[0].startswith("INFO["), lines


def test_stacklevel_attributes_through_wrappers(capsys):
    """A wrapper passes ``stacklevel`` so that the ``[file:line]`` tag names
    its caller, not itself."""
    def wrapper(msg):
        slog.log_warn(msg, stacklevel=2)

    def plain(msg):
        slog.log_warn(msg)  # tags this line inside plain()

    wrapper("via-wrapper")  # tagged here, in this test
    plain("via-plain")
    err = capsys.readouterr().err.splitlines()
    assert "test_torch_logging.py" in err[0] and "test_torch_logging.py" in err[1], err
    wrapped_line = int(err[0].split(":")[1].split("]")[0])
    plain_line = int(err[1].split(":")[1].split("]")[0])
    assert wrapped_line != plain_line


def test_emit_survives_out_of_range_stacklevel(capsys):
    slog.log_error("deep", stacklevel=10_000)  # degrades to ?:0, never raises
    assert "[?:0]" in capsys.readouterr().err


def test_rank_tag_from_torch_distributed(capsys, monkeypatch):
    """Rank 0 without a process group; ``torch.distributed``'s rank with one;
    a fatal line raises after it prints."""
    slog.log_info("before")
    assert "]{0} before" in capsys.readouterr().err
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    slog.log_info("in a group")
    assert "]{3} in a group" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="stop"):
        slog.log_fatal("stop")
    assert "FATAL[" in capsys.readouterr().err


def test_set_level_filters(capsys):
    old = slog._LEVEL
    try:
        slog.set_level("WARN")
        slog.log_info("hidden")
        slog.log_warn("shown")
        slog.set_level(slog.DEBUG)
        slog.log_debug("debug shown")
    finally:
        slog.set_level(old)
    err = capsys.readouterr().err
    assert "hidden" not in err and "shown" in err and "debug shown" in err


def test_realize_logs_grid_shell_and_route(capsys):
    """``realize()`` logs its grid, shell and resolved route at INFO; a
    route that degrades still warns."""
    from stencil_tpu_torch.domain import DistributedDomain

    dd = DistributedDomain(16, 16, 17, device="cpu")
    dd.set_radius(2)
    dd.set_partition(2, 1, 4)
    dd.set_exchange_route("zpack_pallas")
    dd.add_data("q")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dd.realize()
    assert any(issubclass(w.category, RuntimeWarning) and "degrading" in str(w.message) for w in caught)
    err = capsys.readouterr().err
    line = [line for line in err.splitlines() if line.startswith("INFO[domain.py:")]
    assert len(line) == 1, err
    assert "over grid [2,1,4]" in line[0] and "shell lo [2,2,2] hi [2,2,2]" in line[0]
    assert line[0].endswith("route direct)"), line
