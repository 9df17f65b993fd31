"""One PyTorch intra-op thread in each tier-1 worker process.

Tier-1 runs six pytest workers on the host's cores (`-n 6`), and every
worker imports every test module while it collects. PyTorch's CPU ops
default to one thread per core in each of them, so six workers start six
times as many threads as there are cores. The plain versions (ed25519 and
SHA-256 over int64 limb tensors, which the port's tests run on the CPU)
issue many small ops, each a parallel region whose threads wait for one
another; with the cores taken by the other workers' threads and by JAX's
compiles, those waits made one 1.8 s herder case take 118 s. One thread
per worker keeps each small op on its own core: the six costliest port
files took 108 s on six workers instead of 187 s, at a third of the CPU
time, and a plain verify at 128 lanes takes no longer alone.

Importing this module sets it for the process. The test modules that run
the plain versions import it (the mirrored ones through
`torch_mirror_harness`); `chip_smoke.py` does not, nor does any harness it
loads, so the card's host keeps PyTorch's default.
"""

import torch

torch.set_num_threads(1)
