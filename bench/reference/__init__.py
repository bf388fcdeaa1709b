"""Plain PyTorch reference of the PERMANOVA test, independent of the
program: it imports nothing of `repro_torch` and takes nothing the program
made. `draws` is a frozen copy of the permutation arithmetic, `permanova`
the distances and the test in the hat-matrix form."""
