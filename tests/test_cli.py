"""CLI driver smoke tests (in-process, CPU) — the four reference executables."""

import numpy as np
import pytest

from domain_decomposed_pde_solver.cli.assemble_test import main as assemble_main
from domain_decomposed_pde_solver.cli.combine import main as combine_main
from domain_decomposed_pde_solver.cli.decompose import main as decompose_main
from domain_decomposed_pde_solver.cli.matrix_test import main as matrix_main
from domain_decomposed_pde_solver.cli.solve import main as solve_main
from domain_decomposed_pde_solver.io import read_exodus, read_nodal_vars


def test_assemble_cli(data_dir, capsys):
    rc = assemble_main(["--input", str(data_dir / "2blocks.exo"), "--verbose"])
    assert rc == 0
    assert "OK" in capsys.readouterr().out


def test_assemble_cli_missing_file(tmp_path, capsys):
    rc = assemble_main(["--input", str(tmp_path / "nope.exo")])
    assert rc == 1
    assert "FAILED" in capsys.readouterr().err


def test_decompose_cli(data_dir, tmp_path, capsys):
    out = str(tmp_path / "dec.exo")
    rc = decompose_main(
        ["--input", str(data_dir / "brick.exo"), "--output", out,
         "--partitions", "3", "--verbose"]
    )
    assert rc == 0
    back = read_exodus(out)
    assert back.num_elem == read_exodus(str(data_dir / "brick.exo")).num_elem
    assert len(back.blocks) >= 2


def test_solve_cli_end_to_end(data_dir, tmp_path):
    sol = str(tmp_path / "sol.exo")
    prefix = str(tmp_path / "proc-")
    rc = solve_main(
        ["--input", str(data_dir / "brick.exo"), "--solution", sol,
         "--tolerance", "1e-10", "--iterations", "500",
         "--outputPrefix", prefix]
    )
    assert rc == 0
    names, times, vals = read_nodal_vars(sol)
    assert names == ["Steady-State Heat Solution"]
    assert len(times) >= 2  # boundary snapshot + iterations
    # Combine the dumps.
    merged = str(tmp_path / "merged.out")
    assert combine_main(["--prefix", prefix, "--output", merged]) == 0
    text = open(merged).read()
    assert "[Laplacian: A]" in text and "[Solution: X]" in text


def test_solve_cli_gmres_amg(data_dir, tmp_path):
    sol = str(tmp_path / "sol.exo")
    rc = solve_main(
        ["--input", str(data_dir / "brick.exo"), "--solution", sol,
         "--tolerance", "1e-8", "--iterations", "500", "--solver", "gmres",
         "--precond", "chebyshev", "--no-snapshots"]
    )
    assert rc == 0


def test_solve_cli_gmres_snapshot_every_iteration(data_dir, tmp_path):
    """Literal animation parity: --snapshot-every-iteration restarts GMRES
    after EVERY outer iteration and writes a timestep per iteration, the
    reference's solve/writeSolution/reset loop (BelosMueLuSolver.cpp:112-133,
    Krylov reset included)."""
    sol = str(tmp_path / "sol.exo")
    rc = solve_main(
        ["--input", str(data_dir / "rectangle-tris-boundary.exo"),
         "--solution", sol, "--tolerance", "1e-10", "--iterations", "40",
         "--solver", "gmres", "--precond", "jacobi",
         "--snapshot-every-iteration", "--seed", "3"]
    )
    assert rc == 0
    names, times, vals = read_nodal_vars(sol)
    # timestep 0 = boundary snapshot, then exactly one per outer iteration
    n_iter = len(times) - 1
    assert n_iter >= 2  # the reset loop needs several 1-dim Krylov steps
    # each snapshot must strictly improve the residual on the free system
    mesh = read_exodus(str(data_dir / "rectangle-tris-boundary.exo"))
    from domain_decomposed_pde_solver.models import assemble_heat_system
    import scipy.sparse as sp

    sy = assemble_heat_system(mesh)
    S = sp.csr_matrix((sy.A.data, sy.A.indices, sy.A.indptr), shape=sy.A.shape)
    free = sy.free_to_node
    res = [np.linalg.norm(S @ vals[t, 0][free] - sy.b)
           for t in range(1, len(times))]
    assert res[-1] <= 1e-9 * np.linalg.norm(sy.b)
    assert res[-1] < res[0]


def test_solve_cli_sharded(data_dir, tmp_path):
    sol = str(tmp_path / "sol.exo")
    rc = solve_main(
        ["--input", str(data_dir / "brick.exo"), "--solution", sol,
         "--tolerance", "1e-9", "--iterations", "500", "--partitions", "4"]
    )
    assert rc == 0
    names, times, vals = read_nodal_vars(sol)
    # Final values bounded by the nodeset id (single nodeset id=2 -> const 2).
    mesh = read_exodus(str(data_dir / "brick.exo"))
    ids = [ns.id for ns in mesh.node_sets]
    assert vals[-1, 0].min() >= min(ids) - 1e-6
    assert vals[-1, 0].max() <= max(ids) + 1e-6


def test_matrix_test_cli(data_dir, capsys):
    rc = matrix_main(
        ["--input", str(data_dir / "rectangle-tris-boundary.exo"),
         "--iterations", "3000", "--tolerance", "1e-4", "--reportFrequency", "10"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "lambda_max" in out


def test_matrix_test_cli_sharded(data_dir, capsys):
    rc = matrix_main(
        ["--input", str(data_dir / "2blocks.exo"), "--partitions", "2",
         "--iterations", "2000", "--tolerance", "1e-5", "--reportFrequency", "10"]
    )
    assert rc == 0
    assert "lambda_max" in capsys.readouterr().out


def test_solve_cli_f64_amg_refinement(data_dir, tmp_path):
    """Single-device --dtype float64 --precond amg --no-snapshots routes
    through mixed-precision refinement and reaches true f64 accuracy."""
    import numpy as np
    import scipy.sparse as sp

    from domain_decomposed_pde_solver.io import read_exodus
    from domain_decomposed_pde_solver.models import assemble_heat_system

    sol = str(tmp_path / "sol.exo")
    rc = solve_main(
        ["--input", str(data_dir / "brick.exo"), "--solution", sol,
         "--tolerance", "1e-10", "--iterations", "500", "--precond", "amg",
         "--dtype", "float64", "--no-snapshots"]
    )
    assert rc == 0
    mesh = read_exodus(str(data_dir / "brick.exo"))
    sy = assemble_heat_system(mesh)
    S = sp.csr_matrix((sy.A.data, sy.A.indices, sy.A.indptr), shape=sy.A.shape)
    names, times, vals = read_nodal_vars(sol)
    x = vals[-1, 0][np.asarray(sy.free_to_node)]
    rr = np.linalg.norm(S @ x - sy.b) / np.linalg.norm(sy.b)
    assert rr < 1e-9
