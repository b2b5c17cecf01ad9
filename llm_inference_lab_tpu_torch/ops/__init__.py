"""The port's ops. ``kernel_wrappers`` names every wrapper that launches a
kernel: each carries a ``launches`` count, one a launch, on the card only."""


def kernel_wrappers() -> dict:
    """name -> wrapper, for every kernel of the port (the int8 variants, the
    tree variants of D and F, A's f32-output instantiation and A's and B's
    tensor-core paths count apart)."""
    from llm_inference_lab_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_int8,
        flash_decode_tree,
        flash_decode_tree_int8,
    )
    from llm_inference_lab_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_int8
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
        quant_matmul_int8_mma,
        quant_matmul_mma,
    )
    from llm_inference_lab_tpu_torch.ops.rms_norm import add_rms_norm, rms_norm
    from llm_inference_lab_tpu_torch.ops.verify import verify_prefix

    return {"rms_norm": rms_norm, "add_rms_norm": add_rms_norm,
            "quant_matmul_int4": quant_matmul, "quant_matmul_int4_mma": quant_matmul_mma,
            "quant_matmul_int4_f32": quant_matmul_f32,
            "quant_matmul_int4_f32_mma": quant_matmul_f32_mma,
            "quant_matmul_int8": quant_matmul_int8, "quant_matmul_int8_mma": quant_matmul_int8_mma,
            "flash_decode": flash_decode, "flash_decode_int8": flash_decode_int8,
            "flash_prefill": flash_prefill, "flash_prefill_int8": flash_prefill_int8,
            "paged_flash": paged_flash, "paged_flash_int8": paged_flash_int8,
            "flash_decode_tree": flash_decode_tree,
            "flash_decode_tree_int8": flash_decode_tree_int8,
            "paged_flash_tree": paged_flash_tree, "paged_flash_tree_int8": paged_flash_tree_int8,
            "verify_prefix": verify_prefix}
