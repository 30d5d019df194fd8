"""cinn.auto_schedule.cost_model: the scheduling cost models. Costs come
from ``paddle.cost_model.CostModel``; the XGBoost schedule model is not
trained here (no schedule search: dynamo keeps the graph as captured)."""
from ....cost_model import CostModel  # noqa: F401

__all__ = ["CostModel", "CostModelType", "XgbCostModel"]


class CostModelType:
    XGB = "xgb"
    ANALYTIC = "analytic"


class XgbCostModel(CostModel):
    """The reference trains an XGBoost regressor on measured schedules;
    the surface stays and ``train`` raises."""

    def train(self, samples, labels):
        raise NotImplementedError(
            "schedule search is not ported; use CostModel.profile_measure "
            "for a function's cost")
