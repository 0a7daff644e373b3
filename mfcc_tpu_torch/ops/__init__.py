"""Tensor stage library of the port.

`constants` builds the float64 host matrices (window, mel, DCT, lifter) and
carries them onto a device; `chain` is the torch feature chain.
"""
