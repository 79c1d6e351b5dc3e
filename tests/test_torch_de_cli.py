"""The port's de_sim and reuse_vec_opt CLIs (lut_ldpc_torch/cli/) on the
CPU against the JAX package's, on INI files that read the repo's
ensembles/ (the JAX package's own de_sim CLI tests read a reference tree
that is not part of the repo; ROADMAP §C1)."""

import configparser

import pytest
import torch

from lut_ldpc_tpu.cli import de_sim as jax_de_sim
from lut_ldpc_tpu.cli import reuse_vec_opt as jax_reuse
from lut_ldpc_torch.cli import de_sim, reuse_vec_opt

torch.set_num_threads(1)

ENS36 = "ensembles/rate0.50_dv03_dc06.ens"


def thresholds(text):
    return [float(x) for x in text.split("Threshold(s) found = [")[1].split("]")[0].split()]


def reports(tmp_path, body):
    """Run both CLIs on one INI body (results_name filled in); the two
    report texts."""
    out = []
    for name, main, extra in (("jax", jax_de_sim.main, []),
                              ("port", de_sim.main, ["--device", "cpu"])):
        ini = tmp_path / f"{name}.ini"
        report = tmp_path / f"{name}.txt"
        ini.write_text(body.replace("@OUT@", str(report)))
        assert main(["-p", str(ini)] + extra) == 0
        out.append(report.read_text())
    return out


def test_de_sim_lut_report_equals_jax(tmp_path):
    """[LUT] min-LUT q4, 30 iterations, host bisection: the port writes the
    JAX CLI's report, thresholds, lambda2 values and Pe trace included."""
    jax_txt, port_txt = reports(tmp_path, f"""
[Sim]
thr_prec = 1e-3
maxiter_de = 30
results_name = @OUT@
ensemble_filename = {ENS36}

[LUT]
min_lut = true
qbits = 4 4
tree_mode = auto_bin_balanced
""")
    assert "Pe_trace" in port_txt
    assert port_txt.replace(str(tmp_path / "port"), "") == jax_txt.replace(
        str(tmp_path / "jax"), "")
    assert 0.80 < thresholds(port_txt)[0] < 0.88


def test_de_sim_bp_report_equals_jax(tmp_path):
    """[BP] at 8 bits, 100 iterations: the same report as the JAX CLI."""
    jax_txt, port_txt = reports(tmp_path, f"""
[Sim]
thr_prec = 5e-3
maxiter_de = 100
results_name = @OUT@
ensemble_filename = {ENS36}

[BP]
qbits = 8
""")
    assert port_txt == jax_txt
    assert 0.84 < thresholds(port_txt)[0] < 0.90


def test_de_sim_accel_respects_nq_msg_vec(tmp_path):
    """accelerator_sweep = 1 with a uniform q3 Nq_msg_vec override: the
    explorer's bracket explores q3, not the qbits row's q4, so the host
    bisection finds the q4/q3 threshold at 60 iterations (0.8452)."""
    ini = tmp_path / "de.ini"
    ini.write_text(
        "[Sim]\n"
        f"ensemble_filename = {ENS36}\n"
        "thr_prec = 1e-3\nPe_max = 1e-6\nmaxiter_de = 60\n"
        "max_ni_de_iters = 30\naccelerator_sweep = 1\n"
        f"results_name = {tmp_path}/report.txt\n"
        "[LUT]\nqbits = 4 4\nNq_msg_vec = " + " ".join(["3"] * 60)
        + "\nmin_lut = true\n"
    )
    cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    cp.read(str(ini))
    de_sim.de_sim_lut(cp, None, "cpu")
    thr = thresholds((tmp_path / "report.txt").read_text())[0]
    assert 0.83 < thr < 0.855, thr


@pytest.mark.parametrize("accel", [[], ["--accel", "2"]])
def test_reuse_vec_opt_last_line_equals_jax(capsys, accel):
    """The greedy reuse search prints the JAX CLI's last line, with and
    without the pre-ranking (5 candidates in the first round, top 2
    confirmed on the host)."""
    args = ["-m", "-t", "0.6", "-i", "6", "-r", "4", "-p", "1e-6",
            "-d", "3 / 1.0 / 6 / 1.0"] + accel
    assert jax_reuse.main(args) == 0
    jax_out = capsys.readouterr().out
    assert reuse_vec_opt.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Finished." in out
    last = out.strip().splitlines()[-1]
    assert last == jax_out.strip().splitlines()[-1]
    reuse = eval(last.split("= ")[1])
    assert sum(reuse) == 2 and reuse[0] == 0


def test_clis_raise_without_card_when_cuda_asked(tmp_path):
    """Both CLIs default to the card: without one they raise rather than
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ini = tmp_path / "bp.ini"
    ini.write_text(f"[Sim]\nensemble_filename = {ENS36}\n[BP]\nqbits = 6\n")
    with pytest.raises(RuntimeError):
        de_sim.main(["-p", str(ini)])
    with pytest.raises(RuntimeError):
        reuse_vec_opt.main(["-m", "-t", "0.82", "-i", "6", "-r", "4",
                            "-d", "3 / 1.0 / 6 / 1.0"])
