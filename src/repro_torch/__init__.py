"""repro_torch: the PyTorch/CUDA port of the ``repro`` package.

It keeps ``repro``'s module layout and names so each module's
counterpart is easy to find, and it imports neither JAX nor anything of
``repro``. The kernels that ``repro`` wrote in Pallas for the TPU are
CUDA C++ for Hopper here (``csrc/``), built at first use; each keeps a
plain PyTorch version beside it, which is what runs for CPU tensors.

Entry points (``Engine``, ``build_model(...).init``, the serve CLI) run on
``cuda`` unless the caller passes ``device="cpu"``; they never fall back
to the CPU by themselves.
"""


def default_device(device=None):
    """The device an entry point runs on: ``device`` if given, else
    ``cuda`` — which raises here when no GPU is visible."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return torch.device("cuda")
