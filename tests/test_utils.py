"""Utils tests: deterministic dumps + combiner, timers, config."""

import argparse

import numpy as np
import pytest

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.utils import (
    PhaseTimer,
    SolveConfig,
    add_solve_args,
    combine_outputs,
    config_from_args,
    print_csr_matrix,
    print_vector,
)


def test_deterministic_dump_and_combine(data_dir, tmp_path):
    """Per-part dumps + combiner: the merged stream must list every row once,
    in global order, with identical section headers across parts — the
    contract ``mpi_output_combiner.py`` enforces for the reference."""
    mesh = read_exodus(str(data_dir / "rectangle-tris-boundary.exo"))
    sys_ = assemble_heat_system(mesh)
    parts = np.array([0, 1, 0])  # 3 free rows over 2 parts
    prefix = str(tmp_path / "proc-")
    print_csr_matrix(sys_.A, "Laplacian: A", prefix, parts=parts, nparts=2)
    print_vector(sys_.b, "RHS: B", prefix, parts=parts, nparts=2)
    out = str(tmp_path / "combined.out")
    combine_outputs(prefix, out)
    lines = open(out).read().splitlines()
    assert lines[0] == "[Laplacian: A]"
    a_lines = lines[1:4]
    assert [ln.split(" ")[0] for ln in a_lines] == ["0", "1", "2"]  # global order
    assert "[RHS: B]" in lines
    # Row 0 of the toy Laplacian: diag 5 at col 0, -1 at col 2.
    assert a_lines[0] == "0 => [(0,5),(2,-1)]"


def test_combiner_rejects_header_mismatch(tmp_path):
    (tmp_path / "p0.out").write_text("[A]\n~0~ x\n")
    (tmp_path / "p1.out").write_text("[B]\n~1~ y\n")
    with pytest.raises(ValueError, match="section headers"):
        combine_outputs(str(tmp_path / "p"), str(tmp_path / "out"))


def test_combiner_missing_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        combine_outputs(str(tmp_path / "nope-"), str(tmp_path / "out"))


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    rep = t.report()
    assert "a" in rep and "x2" in rep
    assert set(t.as_dict()) == {"a", "b"}


def test_config_defaults_match_reference():
    """Defaults must mirror BelosMueLuSolver.cpp:144-159."""
    cfg = SolveConfig()
    assert cfg.iterations == 300
    assert cfg.tolerance == 1e-14
    assert cfg.solution == "solution.exo"
    assert cfg.report_after_iterations == 10


def test_config_from_args():
    ap = argparse.ArgumentParser()
    add_solve_args(ap)
    args = ap.parse_args(
        ["--input", "m.exo", "--tolerance", "1e-9", "--solver", "gmres",
         "--partitions", "4"]
    )
    cfg = config_from_args(args)
    assert cfg.input == "m.exo"
    assert cfg.tolerance == 1e-9
    assert cfg.solver == "gmres"
    assert cfg.partitions == 4


def test_preconditioner_comparison_amg_beats_ilut(data_dir):
    """The ILUT-parity claim (SURVEY §7): under the reference's own solver
    (GMRES), SA-AMG needs no more iterations than scipy's ILU (~Ifpack2
    ILUT) — in practice several times fewer."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from domain_decomposed_pde_solver.models import assemble_heat_system
    from domain_decomposed_pde_solver.utils.compare import (
        compare_preconditioners,
    )

    sys_ = assemble_heat_system(read_exodus(str(data_dir / "brick.exo")))
    res = compare_preconditioners(sys_.A, sys_.b, tol=1e-10)
    assert res["amg"]["converged"] and res["ilut"]["converged"]
    assert res["amg"]["iterations"] <= res["ilut"]["iterations"]
    assert res["amg"]["iterations"] < res["jacobi"]["iterations"]
