"""Native host code of the port: the BPE merge loop (`fast_bpe`)."""
