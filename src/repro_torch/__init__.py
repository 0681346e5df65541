"""PyTorch/CUDA port of the size-aware W-TinyLFU cache-management system.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and nothing of JAX or of ``repro``. Its count-min-sketch kernels
are hand-written CUDA for Hopper (``kernels/cms/csrc``), built with
``nvcc`` at first use. Entry points run on the card unless the caller asks
for the CPU (``device="cpu"``)::

    from repro_torch.core import REGISTRY, SimulationEngine
    from repro_torch.traces import make_trace

    trace = make_trace("msr2", scale=0.02)
    policy = REGISTRY.build("wtlfu-av-sampled_frequency?sketch_backend=cms",
                            cap, expected_entries=n)
    SimulationEngine().run(policy, trace)
"""
