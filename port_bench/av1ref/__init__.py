"""av1ref: the benchmark's reference decoder, a frozen copy.

A copy of the verification decoder of ``svt_av1_tpu_torch``
(``codec/decoder.py``) and of what it reaches, with the package name
rewritten, taken when the benchmark was defined and cut to the top-level
functions, classes and tables that the decoder can reach: the encoder's
searches, mode decision, rate tables, CUDA kernels and bitstream writers
are left out.  The benchmark decodes the packets that the timed path emits
with it and compares the result with each packet's reconstruction.  It
imports nothing of the program, of ``jax`` or of ``svt_av1_tpu``.

It is not independent of the program: each frame is rebuilt with the
reconstruction code that the encoder itself used when it was copied
(``reconstruct_from_decisions``, ``reconstruct_inter_from_decisions``,
``apply_loop_filter`` and the filters), so it holds the stream and the
reconstruction to each other and later versions of the program to this
one's, not to the AV1 specification.
"""
