"""MP3 decode pipeline: native front-end, JAX device back-end.

- frontend: native C++ entropy stage (side info, scalefactors, Huffman,
  bit reservoir) producing dense granule tensors.
- synthesis: JAX back-end (requantize → stereo → antialias → IMDCT →
  polyphase synthesis) producing PCM on device.
"""
