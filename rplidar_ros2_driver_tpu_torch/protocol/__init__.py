"""Wire-protocol facts (constants, CRC32) the PyTorch package needs: a
copy of the parts of the JAX package's ``protocol/`` that its decoders,
encoders and replay use, so importing them never runs the JAX package."""
