"""The plain reference that decides ``correct``: fp32 PyTorch, no kernel,
no cache, no batching of its own beyond padding with a mask. It imports
nothing of ``uc2_torch`` and takes no weights or tables from it: it reads
the weights and inputs the benchmark made and the program's outputs,
which it only judges."""
