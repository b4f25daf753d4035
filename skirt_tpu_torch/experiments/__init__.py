"""The port's counterparts of the JAX package's Pallas probes (experiments/).

Kernel modules (a plain PyTorch version and the wrapper of a hand-written
CUDA kernel each; CPU tensors take the plain version, CUDA tensors launch
the kernel or raise):
  gather         PG, the table gather of microbench_gather.py,
                 microbench_gather2.py and microbench_pallas_gather*.py
  onehot_gather  PO, the one-hot tensor-core gather of
                 microbench_mxu_gather*.py
  mm             PM, the in-kernel product of microbench_mxu_mm.py

Drivers, run on a CUDA card as `python -m skirt_tpu_torch.experiments.<name>`
(importing them runs nothing):
  microbench_blocked_tally  K8 against K2 (experiments/
                            microbench_blocked_tally.py)
  microbench_gather         PG over the shapes of P1-P10
  microbench_mxu_gather     PO over the stages of P11-P14, and PG on the
                            same 32,768-entry table
  microbench_mxu_mm         PM over the shapes and types of P15
"""
