"""Hand-written Hopper kernels: build, bind, count launches (build.py).

The kernels' wrappers and their plain twins live beside the code they
serve: K1 in codecs/opus/imdct.py, K2 in codecs/opus/synth.py, K7 in
codecs/aac/synth.py, K3 and K9 in dsp/limiter.py, K8 in dsp/binaural.py,
K10 in dsp/resample.py, and the CELT entropy stages K11 (CWRS pulse decode)
in codecs/opus/device_cwrsi.py, K12 (leaf normalization, rotation and the
noise-fill LCG) in codecs/opus/device_leaf.py and K13 (the packed mono
band walk) in codecs/opus/device_bands.py; the CUDA sources are in
iamf_tpu_torch/csrc (K11-K13: celt_cwrsi.cu, celt_leaf.cu, celt_bands.cu).
"""
