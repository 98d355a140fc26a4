"""Neural building blocks, encoders and decoders."""
