"""Model stack: configs, layers, the decoder and its MISO cells."""
