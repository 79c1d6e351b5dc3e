"""Command-line programs of the port, mirroring the reference's prog/
binaries.

python -m lut_ldpc_torch.cli.ber_sim        Monte-Carlo BER/FER simulation
python -m lut_ldpc_torch.cli.de_sim         density-evolution threshold search
python -m lut_ldpc_torch.cli.reuse_vec_opt  greedy LUT-reuse-pattern search
"""
