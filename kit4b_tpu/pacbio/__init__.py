"""pacbiokit4b-equivalent long-read toolkit on device.

Reference: /root/reference/pacbiokit4b (ecreads, contigs, eccontigs,
swservice, kmerdist, filter — pacbiokit4b.cpp:85-94). The SW alignment
engine (CSSW/CSWAlign, SSW.cpp) becomes a batched banded affine-gap DP over
device lanes (sswd.py); the BKS distributed RPC (BKSRequester/Provider)
becomes a shard_map batch dispatcher (parallel/swservice.py)."""
