"""Command-line programs of the port, mirroring the reference's prog/
binaries.

python -m lut_ldpc_torch.cli.ber_sim    Monte-Carlo BER/FER simulation
"""
