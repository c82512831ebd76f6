"""ctrlv_tpu_torch: the serving side of ctrlv_tpu in PyTorch, for one NVIDIA
H100: the Box2Video sampler, the stage-1 bbox sampler and the two-stage
overall pipeline that joins them.

The JAX package ``ctrlv_tpu`` is the reference this port is held against;
this package imports neither JAX nor flax. Its modules mirror that
package's layout and names, carry diffusers parameter names, and keep its
public layouts: images (B, H, W, 3) and videos (B, F, H, W, C) in [-1, 1],
attention operands (B, S, H*D). The kernels on these paths (three
attentions over packed heads, the one-pass BSHD attention, GroupNorm+SiLU,
LayerNorm) are CUDA C++ for sm_90a (``csrc/``), built with nvcc at first use.
"""
