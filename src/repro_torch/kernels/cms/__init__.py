"""Count-min-sketch kernels: plain versions (:mod:`.ref`), Hopper kernels
and their wrappers (:mod:`.cms`), and the public ops (:mod:`.ops`)."""
