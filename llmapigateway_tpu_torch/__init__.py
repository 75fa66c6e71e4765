"""PyTorch/CUDA port of the LLM gateway's serving path.

The package serves ``/v1/chat/completions`` from an in-process engine that
runs on an NVIDIA GPU: plain tensor code is PyTorch, and the paged
attention kernels are CUDA C++ written for Hopper (``csrc/``), built with
``nvcc`` on first use and loaded with ``ctypes``. It imports nothing of the
JAX package ``llmapigateway_tpu``; modules keep that package's module paths
and names so a reader can find each counterpart, and the tests hold every
module to it on the same inputs.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``InferenceEngine(..., device="cpu")``, ``--device cpu``); on a CPU tensor
each kernel wrapper runs its plain PyTorch version instead.
"""
