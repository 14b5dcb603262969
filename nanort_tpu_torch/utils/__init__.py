"""Host utilities of the port (NumPy only): image and EXR output,
copies of ``nanort_tpu.utils.image`` and ``nanort_tpu.utils.exr``."""
