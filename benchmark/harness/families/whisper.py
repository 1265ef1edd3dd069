"""The whisper family (`"model_type": "whisper"`): EmotionWhisper, whisper
with a linear emotion head.

What a family module gives the harness:

- `PUBLISHED`: for each source URL a configuration of this family may
  name, the widths its published `config.json` states (a configuration
  file holds them unchanged; the contract test checks it);
- `dims(raw)`: the sizes and ids of a configuration file;
- `port_config(dims)`: the program's configuration for them;
- `make_weights(dims, seed, device, dtype)`: the seeded weights as a flat
  {name: tensor}, which the plain reference takes, and `port_tree(flat)`,
  the program's parameter tree over the same tensors; `FROZEN`, the
  leaves that do not train;
- `reference`: the plain reference module.
"""

from benchmark.harness import program, spec, weights
from benchmark.reference import whisper as reference  # noqa: F401

PUBLISHED = {
    "https://huggingface.co/openai/whisper-tiny": {
        "d_model": 384, "encoder_layers": 4, "decoder_layers": 4,
        "encoder_attention_heads": 6, "encoder_ffn_dim": 1536,
        "num_mel_bins": 80, "vocab_size": 51865,
        "max_source_positions": 1500},
    "https://huggingface.co/openai/whisper-large-v3": {
        "d_model": 1280, "encoder_layers": 32, "decoder_layers": 32,
        "encoder_attention_heads": 20, "encoder_ffn_dim": 5120,
        "num_mel_bins": 128, "vocab_size": 51866,
        "max_source_positions": 1500},
}

dims = spec.from_dict
port_config = program.configs
make_weights = weights.make
port_tree = weights.tree
FROZEN = weights.FROZEN
