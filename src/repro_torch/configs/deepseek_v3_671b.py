"""DeepSeek-V3 671B — MLA + 256-expert top-8 MoE + shared expert + MTP.

[arXiv:2412.19437; hf]  61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.
Assigned config keeps every layer MoE (the public model has 3 leading dense
layers; the assigned spec lists a uniform MoE stack, which we follow).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,          # MLA: latent-compressed; logical head count
    head_dim=128,
    d_ff=2048,                 # routed-expert hidden dim
    vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, num_shared_experts=1,
                  expert_d_ff=2048, capacity_factor=1.25),
    mtp_depth=1,
    tied_embeddings=False,
    rope_theta=10000.0,
)
