"""ctrlv_tpu_torch: ctrlv_tpu in PyTorch, for one NVIDIA H100: the Box2Video
sampler, the stage-1 bbox sampler, the two-stage overall pipeline that joins
them, the training steps (``train``), diffusers checkpoints in and out
(``train.hf_import``, ``train.hf_export``; the safetensors format in
``utils.safetensors_io``), the data path (``data``), the evaluation
tools (``python -m ctrlv_tpu_torch.tools.eval_overall``,
``tools.eval_video_controlnet``) and the trainers
(``tools.train_video_controlnet``, ``tools.train_video_diffusion``,
``tools.train_vae_finetuning``: f32 master weights under bf16 compute,
training-state checkpoints, in-loop validation).

The JAX package ``ctrlv_tpu`` is the reference this port is held against;
this package imports neither JAX nor flax. Its modules mirror that
package's layout and names, carry diffusers parameter names, and keep its
public layouts: images (B, H, W, 3) and videos (B, F, H, W, C) in [-1, 1],
attention operands (B, S, H*D). The kernels on these paths (three
attentions over packed heads, the one-pass BSHD attention, GroupNorm+SiLU,
LayerNorm, the fused GEGLU feed-forward) are CUDA C++ for sm_90a
(``csrc/``), built with nvcc at first use; each carries a gradient that
recomputes through its plain version.
"""
