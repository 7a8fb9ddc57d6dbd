from vsnca_tpu_torch.utils.video_writer import (
    VideoWriter,
    save_stylized_video,
    evaluate_folder_of_videos,
    generate_control_videos,
)
from vsnca_tpu_torch.utils.flow_viz import flow_to_image, plot_vec_field
from vsnca_tpu_torch.utils.display import plot_losses, save_image_grid, to_uint8
