"""Kernel library of the port: the receive chain's ops on PyTorch tensors.

Each op holds its parameters as tensors on one device;
``op.init_state(channels)`` returns the carried state and
``op(state, x) -> (state, y)`` processes one ``[channels, block]`` block.
"""
