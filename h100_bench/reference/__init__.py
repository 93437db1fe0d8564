"""A frozen plain fp32 copy of the measured model, its losses and its
optimizer step: the yardstick that decides `correct`."""
