"""The benchmark's plain reference of FFR-Net: IR-SE50, RecNet, the
cp2tform alignment and warp, the int8 sites and the training step, in
plain PyTorch, float32 with TF32 off unless a caller asks for a lower
precision (the controls). It imports nothing of the program, of JAX or of
the JAX package, and takes nothing the program made: the weights are the
benchmark's, drawn on the device from the seed (`weights.py`; the program
is handed the same draw), and it works out again the alignment matrices,
the folded BNs, the int8 scales and the training state.

Precision, for every forward here:
  "fp32"   float32 throughout, TF32 off (the caller sets the backends)
  "int8"   every conv and Linear on int8 operands: weights per output
           channel, activations per tensor from this batch's amax, the
           product dequantized to float32 (the control of a bf16 cell)
  "int4"   the int8 configuration's sites at 4 bits (the control of an
           int8 cell), static scales calibrated at 4 bits
"""
