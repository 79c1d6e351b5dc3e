"""Command-line programs of the port, mirroring the reference's prog/
binaries.

python -m lut_ldpc_torch.cli.ber_sim        Monte-Carlo BER/FER simulation
python -m lut_ldpc_torch.cli.de_sim         density-evolution threshold search
python -m lut_ldpc_torch.cli.reuse_vec_opt  greedy LUT-reuse-pattern search
python -m lut_ldpc_torch.cli.peg_gen        ensemble -> PEG code (.alist)
python -m lut_ldpc_torch.cli.alist2ens      alist -> empirical .ens
python -m lut_ldpc_torch.cli.ens2deg        .ens -> PEG .deg
python -m lut_ldpc_torch.cli.dat2alist      PEG compressed-H .dat -> .alist
python -m lut_ldpc_torch.cli.dump_stimuli   codec -> VHDL-testbench stimuli
"""
