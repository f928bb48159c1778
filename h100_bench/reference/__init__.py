"""The plain float32 reference of the benchmark's configurations.

Plain ``torch`` operations in float32 with TF32 off, written from the
published descriptions: CLIP ViT-L/14 (``spec.py`` reads its sizes from a
configuration file), the ``mlp2x_gelu`` projector, M3 pooling as
``adaptive_avg_pool2d``, the splice as a concatenation, and the Mistral and
MPT decoders (``model.py``).  It imports neither JAX nor either package of
the repository, and reads only the weights and inputs the benchmark made;
it runs layer by layer, upcasting one layer's weights at a time, so it fits
beside the program's inputs on one card.
"""
