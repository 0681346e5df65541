"""RWKV-6 wkv6: the Hopper kernel and its wrapper (:mod:`.wkv6`), its plain
PyTorch versions (:mod:`.ref`) and the public entry point (:mod:`.ops`)."""
