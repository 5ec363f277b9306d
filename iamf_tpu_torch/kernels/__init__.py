"""Hand-written Hopper kernels: build, bind, count launches (build.py).

The kernels' wrappers and their plain twins live beside the code they
serve: K1 in codecs/opus/imdct.py, K2 in codecs/opus/synth.py, K7 in
codecs/aac/synth.py, K3 and K9 in dsp/limiter.py, K8 in dsp/binaural.py,
K10 in dsp/resample.py; the CUDA sources are in iamf_tpu_torch/csrc.
"""
