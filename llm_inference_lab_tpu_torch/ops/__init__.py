"""The port's ops. ``kernel_wrappers`` names every wrapper that launches a
kernel: each carries a ``launches`` count, one a launch, on the card only.
``kernel_backends`` says what runs each op the engine dispatches."""

from typing import Dict


def kernel_wrappers() -> dict:
    """name -> wrapper, for every kernel of the port (the int8 variants, the
    tree variants of D and F, A's f32-output instantiation and A's and B's
    tensor-core paths count apart; G the int8 tied head, H the KV-cache
    write)."""
    from llm_inference_lab_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_int8,
        flash_decode_shard,
        flash_decode_shard_int8,
        flash_decode_shard_opts,
        flash_decode_shard_opts_int8,
        flash_decode_shard_tree,
        flash_decode_shard_tree_int8,
        flash_decode_tree,
        flash_decode_tree_int8,
    )
    from llm_inference_lab_tpu_torch.ops.flash_prefill import (
        flash_prefill,
        flash_prefill_int8,
        flash_prefill_shard,
    )
    from llm_inference_lab_tpu_torch.ops.paged_flash import (
        paged_flash,
        paged_flash_int8,
        paged_flash_tree,
        paged_flash_tree_int8,
    )
    from llm_inference_lab_tpu_torch.ops.quant_matmul import (
        quant_matmul,
        quant_matmul_f32,
        quant_matmul_f32_mma,
        quant_matmul_int8,
        quant_matmul_int8_f32,
        quant_matmul_int8_f32_mma,
        quant_matmul_int8_mma,
        quant_matmul_mma,
    )
    from llm_inference_lab_tpu_torch.ops.rms_norm import (
        add_layer_norm,
        add_rms_norm,
        layer_norm,
        rms_norm,
    )
    from llm_inference_lab_tpu_torch.ops.kv_write import kv_write
    from llm_inference_lab_tpu_torch.ops.tied_head import tied_head
    from llm_inference_lab_tpu_torch.ops.verify import verify_prefix

    return {"rms_norm": rms_norm, "add_rms_norm": add_rms_norm, "layer_norm": layer_norm,
            "add_layer_norm": add_layer_norm,
            "quant_matmul_int4": quant_matmul, "quant_matmul_int4_mma": quant_matmul_mma,
            "quant_matmul_int4_f32": quant_matmul_f32,
            "quant_matmul_int4_f32_mma": quant_matmul_f32_mma,
            "quant_matmul_int8": quant_matmul_int8, "quant_matmul_int8_mma": quant_matmul_int8_mma,
            "quant_matmul_int8_f32": quant_matmul_int8_f32,
            "quant_matmul_int8_f32_mma": quant_matmul_int8_f32_mma,
            "flash_decode": flash_decode, "flash_decode_int8": flash_decode_int8,
            "flash_prefill": flash_prefill, "flash_prefill_int8": flash_prefill_int8,
            "paged_flash": paged_flash, "paged_flash_int8": paged_flash_int8,
            "flash_decode_tree": flash_decode_tree,
            "flash_decode_tree_int8": flash_decode_tree_int8,
            "paged_flash_tree": paged_flash_tree, "paged_flash_tree_int8": paged_flash_tree_int8,
            "flash_decode_shard": flash_decode_shard,
            "flash_decode_shard_int8": flash_decode_shard_int8,
            "flash_decode_shard_opts": flash_decode_shard_opts,
            "flash_decode_shard_opts_int8": flash_decode_shard_opts_int8,
            "flash_decode_shard_tree": flash_decode_shard_tree,
            "flash_decode_shard_tree_int8": flash_decode_shard_tree_int8,
            "flash_prefill_shard": flash_prefill_shard,
            "verify_prefix": verify_prefix, "tied_head": tied_head, "kv_write": kv_write}


def kernel_backends(device) -> Dict[str, str]:
    """op the engine dispatches (JAX's registry names, and tied_head and
    kv_write, which JAX leaves to XLA) -> what runs it on `device`: on CUDA
    the csrc/ sources its wrappers build (each wrapper module's LIBRARY, the
    one its launches load), on the CPU "plain" (the
    wrappers' plain versions); "torch" for moe_mlp, PyTorch ops on both
    (ops/moe.py, as JAX's XLA moe_dense: no kernel)."""
    import torch

    from llm_inference_lab_tpu_torch.ops import (
        flash_decode,
        flash_prefill,
        kv_write,
        paged_flash,
        quant_matmul,
        rms_norm,
        tied_head,
        verify,
    )

    libraries = {
        "quant_matmul": (quant_matmul.INT4_LIBRARY, quant_matmul.INT8_LIBRARY),
        "verify_prefix": (verify.LIBRARY,),
        "decode_attention": (flash_decode.LIBRARY, flash_decode.LIBRARY + flash_decode.TREE,
                             flash_decode.SHARD_LIBRARY,
                             flash_decode.SHARD_LIBRARY + flash_decode.TREE),
        "prefill_attention": (flash_prefill.LIBRARY, flash_prefill.SHARD_LIBRARY),
        "paged_attention": (paged_flash.LIBRARY, paged_flash.LIBRARY + flash_decode.TREE),
        "rms_norm": (rms_norm.LIBRARY,),
        "tied_head": (tied_head.LIBRARY,),
        "kv_write": (kv_write.LIBRARY,),
    }
    on_card = torch.device(device).type == "cuda"
    out = {op: (", ".join(f"csrc/{name}.cu" for name in names) if on_card else "plain")
           for op, names in libraries.items()}
    out["moe_mlp"] = "torch"
    return out
