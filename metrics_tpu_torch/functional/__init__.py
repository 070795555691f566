from metrics_tpu_torch.functional.classification import (  # noqa: F401
    accuracy,
    auc,
    auroc,
    average_precision,
    binned_auroc,
    binned_average_precision,
    binned_precision_recall_curve,
    binned_roc,
    calibration_error,
    cohen_kappa,
    confusion_matrix,
    coverage_error,
    critical_success_index,
    dice_score,
    exact_match,
    f1,
    fbeta,
    hamming_distance,
    hinge_loss,
    iou,
    label_ranking_average_precision,
    label_ranking_loss,
    matthews_corrcoef,
    precision,
    precision_recall,
    precision_recall_curve,
    recall,
    roc,
    specificity,
    stat_scores,
)
from metrics_tpu_torch.functional.regression import (  # noqa: F401
    concordance_corrcoef,
    cosine_similarity,
    error_relative_global_dimensionless_synthesis,
    explained_variance,
    kendall_rank_corrcoef,
    kl_divergence,
    log_cosh_error,
    mean_absolute_error,
    mean_absolute_percentage_error,
    mean_relative_error,
    mean_squared_error,
    mean_squared_log_error,
    minkowski_distance,
    multiscale_ssim,
    pearson_corrcoef,
    psnr,
    r2score,
    spearman_corrcoef,
    spectral_angle_mapper,
    ssim,
    symmetric_mean_absolute_percentage_error,
    total_variation,
    tweedie_deviance_score,
    universal_image_quality_index,
    weighted_mean_absolute_percentage_error,
)
from metrics_tpu_torch.functional.retrieval import (  # noqa: F401
    retrieval_average_precision,
    retrieval_fall_out,
    retrieval_hit_rate,
    retrieval_normalized_dcg,
    retrieval_precision,
    retrieval_r_precision,
    retrieval_recall,
    retrieval_reciprocal_rank,
)
from metrics_tpu_torch.functional.audio import (  # noqa: F401
    permutation_invariant_training,
    pit_permutate,
    scale_invariant_signal_distortion_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from metrics_tpu_torch.functional.clustering import (  # noqa: F401
    adjusted_mutual_info_score,
    adjusted_rand_score,
    completeness_score,
    fowlkes_mallows_score,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from metrics_tpu_torch.functional.clustering_intrinsic import (  # noqa: F401
    calinski_harabasz_score,
    davies_bouldin_score,
)
from metrics_tpu_torch.functional.detection.iou import box_iou, generalized_box_iou  # noqa: F401
from metrics_tpu_torch.functional.detection.map import coco_map_padded  # noqa: F401
from metrics_tpu_torch.functional.image_gradients import image_gradients  # noqa: F401
from metrics_tpu_torch.functional.nominal import (  # noqa: F401
    cramers_v,
    pearsons_contingency_coefficient,
    theils_u,
    tschuprows_t,
)
from metrics_tpu_torch.functional.pairwise import (  # noqa: F401
    pairwise_cosine_similarity,
    pairwise_euclidean_distance,
    pairwise_linear_similarity,
    pairwise_manhattan_distance,
)
from metrics_tpu_torch.functional.self_supervised import embedding_similarity  # noqa: F401
from metrics_tpu_torch.functional.nlp import bleu_score  # noqa: F401
from metrics_tpu_torch.functional.text import (  # noqa: F401
    cer,
    edit_distance_padded,
    lcs_length_padded,
    match_error_rate,
    wer,
    word_information_lost,
    word_information_preserved,
)
from metrics_tpu_torch.functional.text_chrf import chrf_score  # noqa: F401
from metrics_tpu_torch.functional.text_edit import edit_distance  # noqa: F401
from metrics_tpu_torch.functional.text_perplexity import perplexity  # noqa: F401
from metrics_tpu_torch.functional.text_rouge import rouge_score  # noqa: F401
from metrics_tpu_torch.functional.text_sacrebleu import sacre_bleu_score  # noqa: F401
from metrics_tpu_torch.functional.text_squad import squad  # noqa: F401
from metrics_tpu_torch.functional.text_ter import translation_edit_rate  # noqa: F401
