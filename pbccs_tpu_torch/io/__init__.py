"""Input and output of the port's CLI: BAM (BGZF), FASTA, the .pbi
index, the shared chunk contract and the yield report."""
