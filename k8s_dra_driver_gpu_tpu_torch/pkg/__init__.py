"""Helpers of the kubelet plugin (the counterparts of the JAX package's
``pkg/`` modules that the whole-GPU prepare path needs): atomic JSON
writes, a file lock with a timeout, the node's boot id, the checkpoint's
claim-state machine and the prepare timer. Standard library only."""
