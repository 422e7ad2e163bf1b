"""Module metrics for classification (counterpart of ``torchmetrics_tpu.classification``): the
stat-scores family (stat scores, accuracy, precision, recall, F-beta) and confusion matrices of
every task, the curve family with its fixed-point metrics, and calibration error."""
from torchmetrics_tpu_torch.classification.accuracy import Accuracy, BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy
from torchmetrics_tpu_torch.classification.auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from torchmetrics_tpu_torch.classification.average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from torchmetrics_tpu_torch.classification.calibration_error import (
    BinaryCalibrationError,
    CalibrationError,
    MulticlassCalibrationError,
)
from torchmetrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from torchmetrics_tpu_torch.classification.f_beta import (
    BinaryF1Score,
    BinaryFBetaScore,
    F1Score,
    FBetaScore,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MultilabelF1Score,
    MultilabelFBetaScore,
)
from torchmetrics_tpu_torch.classification.precision_fixed_recall import (
    BinaryPrecisionAtFixedRecall,
    MulticlassPrecisionAtFixedRecall,
    MultilabelPrecisionAtFixedRecall,
    PrecisionAtFixedRecall,
)
from torchmetrics_tpu_torch.classification.precision_recall import (
    BinaryPrecision,
    BinaryRecall,
    MulticlassPrecision,
    MulticlassRecall,
    MultilabelPrecision,
    MultilabelRecall,
    Precision,
    Recall,
)
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    PrecisionRecallCurve,
)
from torchmetrics_tpu_torch.classification.recall_fixed_precision import (
    BinaryRecallAtFixedPrecision,
    MulticlassRecallAtFixedPrecision,
    MultilabelRecallAtFixedPrecision,
    RecallAtFixedPrecision,
)
from torchmetrics_tpu_torch.classification.roc import ROC, BinaryROC, MulticlassROC, MultilabelROC
from torchmetrics_tpu_torch.classification.specificity_sensitivity import (
    BinarySpecificityAtSensitivity,
    MulticlassSpecificityAtSensitivity,
    MultilabelSpecificityAtSensitivity,
    SpecificityAtSensitivity,
)
from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    StatScores,
)

__all__ = [
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BinaryAUROC",
    "BinaryAccuracy",
    "BinaryAveragePrecision",
    "BinaryCalibrationError",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryFBetaScore",
    "BinaryPrecision",
    "BinaryPrecisionAtFixedRecall",
    "BinaryPrecisionRecallCurve",
    "BinaryROC",
    "BinaryRecall",
    "BinaryRecallAtFixedPrecision",
    "BinarySpecificityAtSensitivity",
    "BinaryStatScores",
    "CalibrationError",
    "ConfusionMatrix",
    "F1Score",
    "FBetaScore",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassAveragePrecision",
    "MulticlassCalibrationError",
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassPrecision",
    "MulticlassPrecisionAtFixedRecall",
    "MulticlassPrecisionRecallCurve",
    "MulticlassROC",
    "MulticlassRecall",
    "MulticlassRecallAtFixedPrecision",
    "MulticlassSpecificityAtSensitivity",
    "MulticlassStatScores",
    "MultilabelAUROC",
    "MultilabelAccuracy",
    "MultilabelAveragePrecision",
    "MultilabelConfusionMatrix",
    "MultilabelF1Score",
    "MultilabelFBetaScore",
    "MultilabelPrecision",
    "MultilabelPrecisionAtFixedRecall",
    "MultilabelPrecisionRecallCurve",
    "MultilabelROC",
    "MultilabelRecall",
    "MultilabelRecallAtFixedPrecision",
    "MultilabelSpecificityAtSensitivity",
    "MultilabelStatScores",
    "Precision",
    "PrecisionAtFixedRecall",
    "PrecisionRecallCurve",
    "ROC",
    "Recall",
    "RecallAtFixedPrecision",
    "SpecificityAtSensitivity",
    "StatScores",
]
